"""Mixture-of-Experts family in plain PyTorch: a Mixtral-style sparse-FFN
transformer.

The counterpart of ``oncilla_tpu/models/moe.py``, with its names in its
order and its dense-dispatch formulation (the GShard/Switch pattern): a
token's top-k experts are chosen from the router's softmax, each (token,
choice) takes a slot of its expert's static capacity
``C = ceil(k*T/E * capacity_factor)`` in choice-major order (every token's
first choice before any token's second, so under overflow a token loses
its secondary expert first), and the expert batch (E, C, D) is made and
undone by one-hot einsums. Expert weights are stacked on an ``E`` axis
after the layer axis, so the FFN is one E-batched product. The attention
half of each block is the dense family's :func:`llama.block`, with the
expert FFN in its ``mlp`` hook.

What differs from the JAX module, by PyTorch idiom:
- The one-hots are comparisons with ``torch.arange``: a dropped pick's
  slot index is at or past ``C``, where ``jax.nn.one_hot`` gives a row of
  zeros and ``F.one_hot`` raises (and on CUDA reads the indices back to
  the host, which a CUDA graph cannot capture).
- The top-k is a stable descending sort: ``jax.lax.top_k`` puts the lower
  index first on equal values, which ``torch.topk`` does not promise.
- Nothing in :func:`route` or :func:`moe_ffn` synchronises with the host
  (no ``.item()``, no boolean indexing, the capacity a Python int of the
  static T), so a decode step through them is captured whole.

Expert parallelism (``mesh``, ``ep_axis``): each process holds ``E / ep``
experts (``train.moe_param_specs``) and, under ``tp``, its columns of their
ffn. The tokens are replicated over ``ep`` and ``tp``, so every process of
an (ep, tp) group routes the same tokens; each computes its experts' slots
of the expert batch, and the combine is a sum over (ep, tp) (``psum``; the
expert input and the combine weights enter through ``copy``, so their
gradients sum the members' parts). Where the JAX package lets GSPMD lower
the dispatch and combine einsums to all-to-alls, this exchange is one
all-reduce of the (T, D) output a layer. Routing is global, as JAX's
``moe_ffn`` sees the global (B, S, D): the capacity comes from the global
token count, a (token, choice)'s slot counts the earlier data processes'
picks of its expert (an exclusive prefix of the per-row counts gathered
over the data axes, in the global token order), and the aux loss is a mean
over every token. Under the pipeline the JAX step routes each dp shard's
microbatch alone, and so does the port's (``train.make_pp_stage_fn``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from oncilla_tpu_torch.models import llama
from oncilla_tpu_torch.models.llama import (
    LlamaConfig,
    block,
    final_logits,
    init_from_spec,
    param_spec,
)
from oncilla_tpu_torch.parallel import collectives as col
from oncilla_tpu_torch.parallel.mesh import DP, TP


@dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @staticmethod
    def tiny() -> "MoeConfig":
        """Test-size config."""
        return MoeConfig(
            vocab=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_hidden=128, max_seq=128, dtype="float32",
            n_experts=4, top_k=2,
        )

    @staticmethod
    def mixtral_8x7b() -> "MoeConfig":
        """Mixtral-8x7B geometry (the public MoE flagship shape)."""
        return MoeConfig(
            vocab=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            ffn_hidden=14336, max_seq=8192, rope_theta=1e6,
            n_experts=8, top_k=2,
        )


def moe_param_spec(cfg: MoeConfig) -> dict:
    """The dense spec with the FFN leaves replaced by E-stacked expert
    weights and a router a layer."""
    spec = dict(param_spec(cfg))
    L, D, E, Fh = cfg.n_layers, cfg.dim, cfg.n_experts, cfg.ffn_hidden
    s_in = 1.0 / math.sqrt(D)
    s_out = 1.0 / math.sqrt(2 * L * D)
    for k in ("w_gate", "w_up", "w_down"):
        del spec[k]
    spec["w_router"] = ((L, D, E), s_in)
    spec["w_gate_e"] = ((L, E, D, Fh), s_in)
    spec["w_up_e"] = ((L, E, D, Fh), s_in)
    spec["w_down_e"] = ((L, E, Fh, D), s_out)
    return spec


def init_moe_params(cfg: MoeConfig, generator: torch.Generator | None = None,
                    device=None, seed: int = 0, keep=None) -> dict:
    """Scaled-normal init on ``device`` (:func:`llama.init_from_spec`,
    ``keep`` as there)."""
    return init_from_spec(moe_param_spec(cfg), cfg.dtype, generator, device,
                          seed, keep)


def capacity(cfg: MoeConfig, tokens: int) -> int:
    """Static per-expert slot count: ceil(k*T/E * capacity_factor)."""
    return max(
        1,
        int(math.ceil(cfg.top_k * tokens / cfg.n_experts
                      * cfg.capacity_factor)),
    )


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a row of zeros, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _global_positions(oh: torch.Tensor, mesh, axes, rows: int) -> torch.Tensor:
    """Each local (token, choice)'s place in its expert's queue counted in
    the global choice-major order, where the T local tokens are ``rows``
    rows (batch entries) of this process's chunk of a batch split over
    ``axes``: first the batch axis (``dp``, rows of earlier processes come
    first), then the sequence axis (a row's earlier chunks come first)."""
    T, K, E = oh.shape
    ohr = oh.reshape(rows, T // rows, K, E)
    cnt = ohr.sum(dim=1)                                         # (rows, K, E)
    counts = col.all_gather(cnt[None], 0, mesh.group(*axes))    # (G, rows, K, E)
    seq = [a for a in axes if a != DP]
    n_seq = mesh.axis_size(*seq)
    n_b = counts.shape[0] // n_seq
    # Pieces in the global token order: (batch process, row, chunk).
    pieces = counts.reshape(n_b, n_seq, rows, K, E).transpose(1, 2).reshape(-1, K, E)
    before = torch.cumsum(pieces, dim=0) - pieces
    total = pieces.sum(dim=0)                                    # (K, E)
    choice_base = torch.cumsum(total, dim=0) - total
    mine = ((mesh.axis_index(*[a for a in axes if a == DP]) * rows
             + torch.arange(rows, device=oh.device)) * n_seq
            + mesh.axis_index(*seq))
    local = torch.cumsum(ohr, dim=1) - ohr
    pos = local + before[mine][:, None] + choice_base
    return pos.reshape(T, K, E)


def route(router_logits: torch.Tensor, top_k: int, cap: int, *, mesh=None,
          axes: tuple = (), rows: int = 1):
    """Top-k capacity-based routing (fp32 throughout).

    router_logits: (T, E). Returns ``(dispatch, combine, aux)``: dispatch
    the 0/1 (T, E, C) assignment, combine dispatch scaled by the
    renormalised top-k gate weights, aux the GShard load-balancing loss
    E·Σₑ fₑ·pₑ (fₑ the share of tokens whose first choice is e, pₑ the mean
    router probability of e; 1 when both are uniform). Slot priority is
    choice-major (module doc); equal probabilities pick the lower expert
    first. With ``mesh`` and data ``axes`` the T tokens are this process's
    ``rows`` rows of a global batch split over them: slots and aux are the
    global batch's (:func:`_global_positions`), and ``cap`` must be the
    global batch's capacity."""
    T, E = router_logits.shape
    group = None if mesh is None else mesh.group(*axes)
    probs = torch.softmax(router_logits.float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = srt.values[:, :top_k]                            # (T, k)
    gate_idx = srt.indices[:, :top_k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    oh = _one_hot(gate_idx, E)                                   # (T, k, E)

    # Position of each (token, choice) in its expert's queue, counted in
    # choice-major order.
    if group is None:
        oh_priority = oh.transpose(0, 1).reshape(top_k * T, E)
        pos = torch.cumsum(oh_priority, dim=0) - oh_priority
        pos = pos.reshape(top_k, T, E).transpose(0, 1)           # (T, k, E)
    else:
        pos = _global_positions(oh, mesh, axes, rows)

    pos_in_expert = (pos * oh).sum(dim=-1)                       # (T, k)
    keep = ((pos < cap) & (oh > 0)).any(dim=-1)                  # (T, k)
    slot = _one_hot(pos_in_expert.to(torch.int32), cap) * keep[..., None]

    dispatch = torch.einsum("tke,tkc->tec", oh, slot)
    combine = torch.einsum("tk,tke,tkc->tec", gate_vals, oh, slot)

    if group is None:
        first_choice_frac = oh[:, 0, :].mean(dim=0)              # (E,)
        mean_prob = probs.mean(dim=0)
    else:
        n = T * mesh.axis_size(*axes)
        first_choice_frac = col.psum(oh[:, 0, :].sum(dim=0), group) / n
        mean_prob = col.psum(probs.sum(dim=0), group) / n
    aux = E * torch.sum(first_choice_frac * mean_prob)
    return dispatch, combine, aux


def moe_ffn(h: torch.Tensor, lp: dict, cfg: MoeConfig, *, mesh=None,
            ep_axis: str | None = None, seq_axis: str | None = None):
    """The sparse FFN: route, dispatch, E-batched SwiGLU, combine.

    h: (B, S, D), the rmsnorm'd residual branch; ``lp`` holds this layer's
    ``w_router``/``w_gate_e``/``w_up_e``/``w_down_e``. The dispatch and
    combine tensors are cast to the activation dtype before their einsums,
    as in the JAX module (in bf16 the gate weights round before the
    combine). With ``mesh``, h is this process's shard of the batch (split
    over ``dp`` and ``seq_axis``, replicated over ``ep_axis`` and ``tp``)
    and ``lp`` its shard of the experts (module docstring). Returns
    ``(y, aux)``."""
    B, S, D = h.shape
    T = B * S
    x = h.reshape(T, D)
    axes = () if mesh is None else llama.data_axes(mesh, seq_axis)
    cap = capacity(cfg, T * (1 if mesh is None else mesh.axis_size(*axes)))

    router_logits = x.float() @ lp["w_router"].float()
    dispatch, combine, aux = route(router_logits, cfg.top_k, cap, mesh=mesh,
                                   axes=axes, rows=B)

    group = None if mesh is None else mesh.group(*(a for a in (ep_axis, TP) if a))
    combine = combine.to(h.dtype)
    dispatch = dispatch.to(h.dtype)
    if group is not None:
        # This process's experts' slots; x and the combine weights enter
        # through copy, so their gradients sum the (ep, tp) members' parts.
        n_local = lp["w_gate_e"].shape[0]
        lo = (mesh.axis_index(ep_axis) if ep_axis else 0) * n_local
        x = col.copy(x, group)
        combine = col.copy(combine, group)[:, lo:lo + n_local]
        dispatch = dispatch[:, lo:lo + n_local]
    xe = torch.einsum("tec,td->ecd", dispatch, x)
    g = torch.einsum("ecd,edf->ecf", xe, lp["w_gate_e"])
    u = torch.einsum("ecd,edf->ecf", xe, lp["w_up_e"])
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u, lp["w_down_e"])
    y = col.psum(torch.einsum("tec,ecd->td", combine, ye), group)
    return y.reshape(B, S, D), aux


# Per-layer (stacked) leaves of the MoE family (the dense family's
# counterpart is llama.LAYER_KEYS).
MOE_LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "ln_attn", "ln_mlp",
    "w_router", "w_gate_e", "w_up_e", "w_down_e",
)


def moe_layer_params(params: dict, i: int) -> dict:
    return {k: params[k][i] for k in MOE_LAYER_KEYS}


def forward(params: dict, tokens: torch.Tensor, cfg: MoeConfig, *, mesh=None,
            seq_axis: str | None = None, ep_axis: str | None = None,
            remat=False, ring: bool = True):
    """fp32 logits and the summed router aux loss for a (B, S) token batch;
    ``remat`` as the dense family's (:func:`llama._remat_wrap`). With
    ``mesh``, the logits are this process's block (its tokens, its vocab
    columns under ``tp``)."""
    x, aux_total = forward_hidden(params, tokens, cfg, mesh=mesh,
                                  seq_axis=seq_axis, ep_axis=ep_axis,
                                  remat=remat, ring=ring)
    return final_logits(params, x, cfg), aux_total


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: MoeConfig, *,
                   mesh=None, seq_axis: str | None = None,
                   ep_axis: str | None = None, remat=False, ring: bool = True):
    """Final hidden states (pre-``ln_out``) and the summed router aux. Each
    stacked leaf is unbound once, so its gradient is one stack of the
    layers' gradients. With ``mesh``: this process's shards, attention as
    the dense family's (``tp``, the ring over ``seq_axis``), the expert
    layer over ``ep_axis`` with global routing."""
    B, S = tokens.shape
    x = llama.embed(params, tokens, cfg, mesh)
    positions = llama.positions_of(S, mesh, seq_axis, tokens.device)
    attend = llama.make_attend(S, mesh, seq_axis, window=cfg.window,
                               device=tokens.device, ring=ring)
    tp = llama.tp_group(mesh)

    def one_block(x, lp):
        box = {}

        def mlp(hn):
            y, box["aux"] = moe_ffn(hn, lp, cfg, mesh=mesh, ep_axis=ep_axis,
                                    seq_axis=seq_axis)
            return y

        out = block(cfg, x, lp, positions, attend, mlp=mlp, tp=tp)
        return out, box["aux"]

    one_block = llama._remat_wrap(one_block, remat)
    layers = {k: params[k].unbind(0) for k in MOE_LAYER_KEYS}
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        x, aux = one_block(x, {k: layers[k][i] for k in MOE_LAYER_KEYS})
        aux_total = aux_total + aux
    return x, aux_total


def loss_fn(params, tokens, cfg: MoeConfig, *, ce_block: int | None = None,
            mesh=None, **kw) -> torch.Tensor:
    """Next-token cross entropy plus the weighted router load-balancing
    loss; ``ce_block`` switches to the dense family's
    :func:`llama.blocked_cross_entropy` (the same ln_out/lm_head leaves).
    With a ``mesh`` of more than one process: this process's shards, and
    the global loss on every process."""
    if mesh is not None and mesh.size > 1:
        x, aux = forward_hidden(params, tokens, cfg, mesh=mesh, **kw)
        ce = llama.sharded_cross_entropy(params, x, tokens, cfg, mesh,
                                         kw.get("seq_axis"), ce_block)
        return ce + cfg.router_aux_weight * aux
    if ce_block is not None:
        x, aux = forward_hidden(params, tokens, cfg, **kw)
        ce = llama.blocked_cross_entropy(params, x, tokens[:, 1:], cfg,
                                         block=ce_block)
        return ce + cfg.router_aux_weight * aux
    logits, aux = forward(params, tokens, cfg, **kw)
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return -ll.mean() + cfg.router_aux_weight * aux


# -- decode (the dense family's KV-cache machinery) ------------------------


@functools.lru_cache(maxsize=64)
def mlp_of(cfg: MoeConfig, mesh=None, ep_axis: str | None = None):
    """``mlp_of(lp) -> mlp``, the family hook of the dense decode and
    paging machinery (``llama.decode_step``, the ``kv_paging`` steps and
    decoders). Memoised on (cfg, mesh, ep_axis), as in the JAX module:
    equal configs share one callable, so a graphed step bound to it
    (``kv_paging.hooked_step``) is one graph cache key, not one a
    decoder. With ``mesh``/``ep_axis`` each decode FFN runs this process's
    experts and sums over ``ep`` (a mesh without ``tp``: the decode
    attention takes whole heads)."""
    if mesh is not None and mesh.axis_size(TP) > 1:
        raise ValueError("the decode hooks take expert parallelism only: "
                         "a mesh with tp > 1 splits the attention heads")

    def of(lp):
        def mlp(hn):
            return moe_ffn(hn, lp, cfg, mesh=mesh, ep_axis=ep_axis)[0]

        return mlp

    return of


def paged_hooks(cfg: MoeConfig, mesh=None, ep_axis: str | None = None) -> dict:
    """kwargs for the paged decoders, so MoE KV history pages through OCM
    as the dense family's does: ``BucketedPagedDecoder(params, cfg, ctx,
    **moe.paged_hooks(cfg))``."""
    return dict(layer_params_fn=moe_layer_params,
                mlp_of=mlp_of(cfg, mesh, ep_axis))


def decode_step(params, token, pos, kv_cache, cfg: MoeConfig, *, mesh=None,
                ep_axis: str | None = None):
    """Single-token MoE decode: :func:`llama.decode_step` with the expert
    FFN in every layer, over the dense (L, B, KV, T, Hd) cache layout.

    At decode T = B tokens route a step, so capacity rarely binds: a token
    dropped in a teacher-forced forward (where all B·S tokens compete)
    keeps its expert here, and decode matches the forward only when
    capacity is ample."""
    return llama.decode_step(
        params, token, pos, kv_cache, cfg,
        layer_params_fn=moe_layer_params, mlp_of=mlp_of(cfg, mesh, ep_axis),
    )


def generate(params, prompt, kv_cache, cfg: MoeConfig, steps: int, *,
             mesh=None, ep_axis: str | None = None, **kw):
    """MoE continuation: :func:`llama.generate` with the MoE decode step."""
    return llama.generate(
        params, prompt, kv_cache, cfg, steps,
        step_fn=functools.partial(decode_step, mesh=mesh, ep_axis=ep_axis),
        **kw)
