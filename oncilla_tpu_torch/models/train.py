"""Training steps for the model families, on one device or sharded over a
:class:`~oncilla_tpu_torch.parallel.mesh.Mesh`: the counterpart of
``oncilla_tpu/models/train.py``.

A step is the family's loss (autograd for the gradients), the gradients of
every leaf summed over the mesh's data axes, then the in-place AdamW of
:mod:`oncilla_tpu_torch.models.optim`: the counterpart of the JAX step's
``value_and_grad`` -> ``tx.update`` -> ``apply_updates`` with its params
and state donated. ``offload_opt`` keeps Adam's moments in pinned host
memory (the JAX package's ``memory_kind="pinned_host"`` placement): the
step brings each leaf's moments to the card and sends them back.

Mesh axes: ``dp`` (batch data parallel), ``tp`` (tensor parallel over
heads, ffn and vocab), ``sp`` (sequence parallel, ring attention), ``ep``
(expert parallel), ``pp`` (pipeline, GPipe). Where the JAX package places
global arrays under ``NamedSharding``s and lets GSPMD insert the
collectives, each process here holds its shard of every leaf under the
same ``PartitionSpec``s (``param_specs`` and its siblings; ``shard_params``
takes a slice of a full leaf, ``gather_params`` puts it back together), and
the model code calls the collectives
(:mod:`oncilla_tpu_torch.parallel.collectives`), each with JAX's transpose
as its gradient. A leaf replicated over an axis whose processes see other
data (``dp``, ``sp``) gets its gradient summed over that axis; over an
axis whose processes see the same tokens (``tp``; ``ep`` on the (dp, ep,
tp) mesh) the collectives already leave every member the whole gradient.
AdamW is elementwise, so each process updating its own shard is the global
update. On a mesh of one every step is the one-device step: the mesh adds
no operation.

A sharded step takes this process's slice of each batch (``prefetch_to_mesh``
yields it; :func:`shard_batch` cuts it from a global batch) and returns the
global loss on every process.
"""

from __future__ import annotations

import numpy as np
import torch

from oncilla_tpu_torch.models import llama
from oncilla_tpu_torch.models.llama import (
    LAYER_KEYS,
    LlamaConfig,
    init_params,
    init_params_host,
    param_spec,
)
from oncilla_tpu_torch.models.optim import EmptyState, ScaleByAdamState, adamw
from oncilla_tpu_torch.parallel import collectives as col
from oncilla_tpu_torch.parallel.mesh import (
    DP,
    EP,
    PP,
    SP,
    TP,
    Mesh,
    NamedSharding,
    P,
    gather,
    shard,
)
from oncilla_tpu_torch.utils.platform import resolve_device


# -- meshes ------------------------------------------------------------------


def _world(n_devices: int | None) -> int:
    import torch.distributed as dist

    if n_devices is not None:
        return n_devices
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: int | None = None, device=None, shape=None) -> Mesh:
    """Factor the processes into a (dp, tp, sp) mesh: sp gets the largest
    power-of-two factor <= 2, tp next, rest dp (the JAX factoring), or
    ``shape`` (dp, tp, sp) when given. ``n_devices`` defaults to the
    world's size; a mesh of more than one process made without a process
    group is a layout (its shape answers, its collectives raise)."""
    if shape is None:
        n = _world(n_devices)
        sp = 2 if n % 2 == 0 and n >= 4 else 1
        tp = 2 if (n // sp) % 2 == 0 and (n // sp) >= 2 else 1
        shape = (n // (sp * tp), tp, sp)
    return Mesh(dict(zip((DP, TP, SP), shape)), device=device)


def make_moe_mesh(n_devices: int | None = None, n_experts: int | None = None,
                  device=None, shape=None) -> Mesh:
    """Factor the processes into a (dp, ep, tp) mesh: ep first, then tp,
    rest dp. Without ``n_experts`` ep stays <= 2; with it ep grows to the
    largest power-of-two divisor of the process count not above it (the
    JAX factoring); ``shape`` (dp, ep, tp) overrides."""
    if shape is None:
        n = _world(n_devices)
        ep_cap = 2 if n_experts is None else n_experts
        ep = 1
        while ep * 2 <= ep_cap and n % (ep * 2) == 0:
            ep *= 2
        tp = 2 if (n // ep) % 2 == 0 else 1
        shape = (n // (ep * tp), ep, tp)
    return Mesh(dict(zip((DP, EP, TP), shape)), device=device)


def make_pp_mesh(n_devices: int | None = None, n_layers: int = 4, device=None,
                 shape=None) -> Mesh:
    """Factor the processes into a (dp, pp) mesh: pp the largest power of
    two <= 4 dividing both the process count and ``n_layers``; rest dp
    (the JAX factoring); ``shape`` (dp, pp) overrides."""
    if shape is None:
        n = _world(n_devices)
        pp = next((c for c in (4, 2) if n % c == 0 and n_layers % c == 0), 1)
        shape = (n // pp, pp)
    return Mesh(dict(zip((DP, PP), shape)), device=device)


# -- partition specs ---------------------------------------------------------


def param_specs(cfg: LlamaConfig) -> dict:
    """PartitionSpecs: heads and ffn over tp, vocab over tp for the two big
    tables (the JAX package's)."""
    return {
        "embed": P(TP, None),
        "wq": P(None, None, TP),
        "wk": P(None, None, TP),
        "wv": P(None, None, TP),
        "wo": P(None, TP, None),
        "w_gate": P(None, None, TP),
        "w_up": P(None, None, TP),
        "w_down": P(None, TP, None),
        "ln_attn": P(None, None),
        "ln_mlp": P(None, None),
        "ln_out": P(None),
        "lm_head": P(None, TP),
    }


def moe_param_specs(cfg) -> dict:
    """The MoE family's: experts over ep, their ffn over tp, the router
    replicated."""
    specs = dict(param_specs(cfg))
    for k in ("w_gate", "w_up", "w_down"):
        del specs[k]
    specs["w_router"] = P(None, None, None)
    specs["w_gate_e"] = P(None, EP, None, TP)
    specs["w_up_e"] = P(None, EP, None, TP)
    specs["w_down_e"] = P(None, EP, TP, None)
    return specs


def pp_param_specs(cfg: LlamaConfig) -> dict:
    """Layer-stacked leaves split over pp on the stacked axis; embed, norm
    and head replicated (they run outside the pipeline)."""
    return {k: (P(PP) if k in LAYER_KEYS else P()) for k in param_spec(cfg)}


def moe_pp_param_specs(cfg) -> dict:
    """The MoE family's layer-stacked leaves (attention, router, experts)
    over pp; embed, norm and head replicated."""
    from oncilla_tpu_torch.models.moe import MOE_LAYER_KEYS, moe_param_spec

    return {k: (P(PP) if k in MOE_LAYER_KEYS else P()) for k in moe_param_spec(cfg)}


def data_spec() -> P:
    """Batch over dp, sequence over sp (ring attention consumes it)."""
    return P(DP, SP)


def shard_params(params: dict, mesh: Mesh, specs: dict) -> dict:
    """This process's slice of each full leaf, on the mesh's device."""
    return {k: shard(v, mesh, specs[k]) for k, v in params.items()}


def gather_params(params: dict, mesh: Mesh, specs: dict) -> dict:
    """The full leaves from every process's shards (a collective)."""
    return {k: gather(v, mesh, specs[k]) for k, v in params.items()}


def shard_batch(tokens, mesh: Mesh, spec: P = None) -> torch.Tensor:
    """This process's slice of a global (B, S) batch under ``spec``
    (``data_spec()`` by default; the axes the mesh lacks count as 1)."""
    t = tokens if isinstance(tokens, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(tokens))
    return shard(t, mesh, data_spec() if spec is None else spec)


def state_shardings(mesh: Mesh, specs: dict) -> dict:
    """``NamedSharding``s of a ``{"params", "opt"}`` train state, for
    :func:`~oncilla_tpu_torch.models.checkpoint.load_sharded`."""
    ns = {k: NamedSharding(mesh, s) for k, s in specs.items()}
    return {"params": ns, "opt": (ScaleByAdamState(NamedSharding(mesh, P()),
                                                   dict(ns), dict(ns)),
                                  EmptyState(), EmptyState())}


# -- state factories ---------------------------------------------------------


def _state(params: dict, lr: float, offload_opt: bool, mu_dtype):
    tx = adamw(lr, weight_decay=0.01, mu_dtype=mu_dtype)
    return params, tx.init(params, host=offload_opt), tx


def _keeper(mesh, specs, device=None):
    """``init_*``'s ``keep`` hook: each whole leaf's slice here (None on a
    mesh of one, which keeps whole leaves)."""
    if mesh is None or mesh.size == 1:
        return None
    return lambda name, t: shard(t, mesh, specs[name], device=device or t.device)


def _device_of(mesh, device):
    return mesh.device if mesh is not None and device is None else device


def make_sharded_state(params: dict, specs: dict, mesh: Mesh, lr: float = 3e-4,
                       offload_opt: bool = False,
                       mu_dtype: torch.dtype | None = None):
    """The JAX ``_sharded_state``: (params, opt_state, tx) of full
    ``params`` (JAX's, carried across with ``params_from_jax``) sliced
    under ``specs`` and ``adamw(lr, 0.01, mu_dtype)``'s fresh state of the
    slices, the moments in pinned host memory with ``offload_opt``."""
    return _state(shard_params(params, mesh, specs), lr, offload_opt, mu_dtype)


def make_train_state(cfg: LlamaConfig, generator: torch.Generator | None = None,
                     lr: float = 3e-4, offload_opt: bool = False,
                     mu_dtype: torch.dtype | None = None, device=None,
                     seed: int = 0, mesh: Mesh | None = None):
    """(params, opt_state, tx): parameters drawn on ``device`` (the mesh's
    by default) from ``generator`` (one seeded with ``seed`` when not
    given) and the JAX package's optimizer, ``adamw(lr, weight_decay=0.01,
    mu_dtype)``. With ``mesh``, each process draws every leaf in turn and
    keeps its slice under :func:`param_specs`, so the shards are the
    one-device state's."""
    device = _device_of(mesh, device)
    params = init_params(cfg, generator, device, seed,
                         keep=_keeper(mesh, param_specs(cfg)))
    return _state(params, lr, offload_opt, mu_dtype)


def make_train_state_host(seed: int, cfg: LlamaConfig, lr: float = 3e-4,
                          offload_opt: bool = False,
                          mu_dtype: torch.dtype | None = None, device=None,
                          mesh: Mesh | None = None):
    """As :func:`make_train_state`, from the JAX package's numpy draws
    (:func:`~oncilla_tpu_torch.models.llama.init_params_host`): the same
    initial weights as its ``make_train_state_host``, sliced under
    :func:`param_specs` on a mesh."""
    device = _device_of(mesh, device)
    keep = _keeper(mesh, param_specs(cfg), device="cpu")
    return _state(init_params_host(seed, cfg, device, keep=keep), lr,
                  offload_opt, mu_dtype)


def make_moe_train_state(cfg, generator: torch.Generator | None = None,
                         lr: float = 3e-4, offload_opt: bool = False,
                         mu_dtype: torch.dtype | None = None, device=None,
                         seed: int = 0, mesh: Mesh | None = None):
    """The MoE family's state (``moe.init_moe_params``), sliced under
    :func:`moe_param_specs` on a mesh."""
    from oncilla_tpu_torch.models.moe import init_moe_params

    device = _device_of(mesh, device)
    params = init_moe_params(cfg, generator, device, seed,
                             keep=_keeper(mesh, moe_param_specs(cfg)))
    return _state(params, lr, offload_opt, mu_dtype)


def make_pp_train_state(cfg: LlamaConfig, generator=None, lr: float = 3e-4,
                        offload_opt: bool = False, mu_dtype=None, device=None,
                        seed: int = 0, mesh: Mesh | None = None):
    """The dense family's state sliced under :func:`pp_param_specs`."""
    device = _device_of(mesh, device)
    params = init_params(cfg, generator, device, seed,
                         keep=_keeper(mesh, pp_param_specs(cfg)))
    return _state(params, lr, offload_opt, mu_dtype)


def make_moe_pp_train_state(cfg, generator=None, lr: float = 3e-4,
                            offload_opt: bool = False, mu_dtype=None,
                            device=None, seed: int = 0, mesh: Mesh | None = None):
    """The MoE family's state sliced under :func:`moe_pp_param_specs`."""
    from oncilla_tpu_torch.models.moe import init_moe_params

    device = _device_of(mesh, device)
    params = init_moe_params(cfg, generator, device, seed,
                             keep=_keeper(mesh, moe_pp_param_specs(cfg)))
    return _state(params, lr, offload_opt, mu_dtype)


# -- steps -------------------------------------------------------------------


def _check_placement(params: dict, opt_state, offload_opt: bool) -> None:
    """Adam's moments in host memory with ``offload_opt``, else beside the
    parameters."""
    have = next(iter(opt_state[0].mu.values())).device
    want = (torch.device("cpu") if offload_opt
            else next(iter(params.values())).device)
    if have != want:
        raise ValueError(f"offload_opt={offload_opt}: Adam's moments are on "
                         f"{have}, expected on {want}")


def _make_step(loss_of, tx, mesh, reduce_axes, offload_opt: bool, opt_state,
               fold_steps: int):
    """The shared step factory: ``loss_of(params, tokens)`` the global loss
    (replicated), the gradients summed over ``reduce_axes`` (the data axes)
    and AdamW in place. ``fold_steps`` N > 0 runs N steps on the batch back
    to back with no host synchronisation and returns the last loss."""
    if not offload_opt and opt_state is not None:
        raise ValueError(
            "an opt_state example was passed but offload_opt is False: the "
            "offloaded (pinned host) state needs offload_opt=True on the "
            "step too")
    if offload_opt and opt_state is None:
        raise ValueError(
            "offload_opt needs opt_state (the state built by the matching "
            "make_*_train_state(offload_opt=True))")
    group = None if mesh is None else mesh.group(*reduce_axes)

    def one(params, opt_state, tokens):
        _check_placement(params, opt_state, offload_opt)
        # Detached aliases carry the graph, so the caller's tensors stay
        # plain (requires_grad False) and are updated in place below.
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_of(leaves, tokens)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        for g in grads:
            col.all_reduce_(g, group)
        tx.step(params, dict(zip(params, grads)), opt_state)
        return params, opt_state, loss.detach()

    def step(params, opt_state, tokens):
        for _ in range(max(fold_steps, 1)):
            params, opt_state, loss = one(params, opt_state, tokens)
        return params, opt_state, loss

    return step


def _seq_axis(mesh) -> str | None:
    return SP if mesh is not None and mesh.axis_size(SP) > 1 else None


def make_train_step(cfg: LlamaConfig, tx, remat=False,
                    offload_opt: bool = False, opt_state=None,
                    ce_block: int | None = None, fold_steps: int = 0, *,
                    mesh: Mesh | None = None, use_ring: bool = True):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``,
    updating params and state in place. ``remat`` and ``ce_block`` as in
    :func:`~oncilla_tpu_torch.models.llama.loss_fn`; ``offload_opt`` needs
    the state of the matching ``make_train_state*(offload_opt=True)`` as
    ``opt_state``, and a state passed without it raises, as the JAX
    package's step factory does. ``fold_steps`` N > 0 runs N steps on the
    batch back to back. With ``mesh`` (dp, tp, sp): this process's shards
    and its ``data_spec()`` slice of the batch; attention is the ring over
    sp (``use_ring`` False: the K/V gathered over sp)."""
    seq = _seq_axis(mesh)

    def loss_of(p, tokens):
        return llama.loss_fn(p, tokens, cfg, mesh=mesh, seq_axis=seq,
                             ring=use_ring, remat=remat, ce_block=ce_block)

    return _make_step(loss_of, tx, mesh, (DP, SP), offload_opt, opt_state,
                      fold_steps)


def make_moe_train_step(cfg, tx, remat=False, offload_opt: bool = False,
                        opt_state=None, ce_block: int | None = None,
                        fold_steps: int = 0, *, mesh: Mesh | None = None):
    """The MoE step over the (dp, ep, tp) mesh: tokens ``P(DP, None)``
    (replicated over ep and tp), the experts over ep, global routing
    (:mod:`~oncilla_tpu_torch.models.moe`); gradients summed over dp. On a
    mesh of one (or none), the one-device MoE step."""
    from oncilla_tpu_torch.models import moe

    def loss_of(p, tokens):
        return moe.loss_fn(p, tokens, cfg, mesh=mesh, ep_axis=EP, remat=remat,
                           ce_block=ce_block)

    return _make_step(loss_of, tx, mesh, (DP,), offload_opt, opt_state,
                      fold_steps)


def make_pp_stage_fn(cfg, moe_aux: bool = False):
    """The per-stage GPipe body shared by both families: this stage's
    layers in turn. With ``moe_aux`` the FFN is the expert layer, routing
    the microbatch alone (as the JAX stage does inside ``shard_map``), and
    the stage returns (activations, summed router aux)."""
    from oncilla_tpu_torch.models.moe import moe_ffn

    def stage_fn(stage_params, x):
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        attend = llama.make_attend(S, window=cfg.window, device=x.device)
        layers = {k: v.unbind(0) for k, v in stage_params.items()}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(len(next(iter(layers.values())))):
            lp = {k: v[i] for k, v in layers.items()}
            if not moe_aux:
                x = llama.block(cfg, x, lp, positions, attend)
                continue
            box = {}

            def mlp(hn, lp=lp, box=box):
                y, box["aux"] = moe_ffn(hn, lp, cfg)
                return y

            x = llama.block(cfg, x, lp, positions, attend, mlp=mlp)
            aux = aux + box["aux"]
        return (x, aux) if moe_aux else x

    return stage_fn


def _make_pp_loss(cfg, mesh: Mesh, microbatches: int, layer_keys,
                  moe_aux: bool = False, remat: bool = False,
                  ce_block: int | None = None):
    """The GPipe loss: embed -> the pipelined layer stack -> head -> CE
    (plus the router aux, divided by ``microbatches`` so its scale matches
    the non-pipelined family's one term a layer). ``remat`` recomputes
    each stage in the backward."""
    from oncilla_tpu_torch.parallel.pipeline import pipeline_apply

    stage_fn = make_pp_stage_fn(cfg, moe_aux=moe_aux)

    def pp_loss(params, tokens):
        x = llama.embed(params, tokens, cfg)
        blocks = {k: params[k] for k in layer_keys}
        res = pipeline_apply(stage_fn, blocks, x, mesh=mesh, axis_name=PP,
                             batch_axis=DP, microbatches=microbatches,
                             with_aux=moe_aux, remat=remat)
        x, aux = res if moe_aux else (res, None)
        if mesh.size > 1:
            ce = llama.sharded_cross_entropy(params, x, tokens, cfg, mesh,
                                             ce_block=ce_block)
        elif ce_block is not None:
            ce = llama.blocked_cross_entropy(params, x, tokens[:, 1:], cfg,
                                             block=ce_block)
        else:
            logp = torch.log_softmax(llama.final_logits(params, x, cfg)[:, :-1],
                                     dim=-1)
            ce = -logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0].mean()
        if moe_aux:
            ce = ce + cfg.router_aux_weight * aux / microbatches
        return ce

    return pp_loss


def make_pp_train_step(cfg: LlamaConfig, tx, microbatches: int = 2,
                       remat: bool = False, offload_opt: bool = False,
                       opt_state=None, ce_block: int | None = None, *,
                       mesh: Mesh):
    """The GPipe step over the (dp, pp) mesh: the stacked layers split over
    pp, activations stage to stage by point-to-point exchange
    (:mod:`~oncilla_tpu_torch.parallel.pipeline`), embed and head
    replicated; tokens ``P(DP, None)``; gradients summed over dp."""
    return _make_step(
        _make_pp_loss(cfg, mesh, microbatches, LAYER_KEYS, remat=remat,
                      ce_block=ce_block),
        tx, mesh, (DP,), offload_opt, opt_state, 0)


def make_moe_pp_train_step(cfg, tx, microbatches: int = 2, remat: bool = False,
                           offload_opt: bool = False, opt_state=None,
                           ce_block: int | None = None, *, mesh: Mesh):
    """The GPipe step for the MoE family: the expert layers ride the
    pipeline like dense blocks and the router aux crosses it through the
    executor's aux channel."""
    from oncilla_tpu_torch.models.moe import MOE_LAYER_KEYS

    return _make_step(
        _make_pp_loss(cfg, mesh, microbatches, MOE_LAYER_KEYS, moe_aux=True,
                      remat=remat, ce_block=ce_block),
        tx, mesh, (DP,), offload_opt, opt_state, 0)


def sample_batch(rng: np.random.Generator, cfg: LlamaConfig, batch: int,
                 seq: int, device=None) -> torch.Tensor:
    """Uniform token ids (batch, seq), int32: the JAX package's draws."""
    ids = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    return torch.from_numpy(ids).to(resolve_device(device))


def make_eval_step(cfg: LlamaConfig, *, mesh: Mesh | None = None,
                   use_ring: bool = True):
    """``step(params, tokens) -> loss``: mean next-token cross entropy, no
    gradients; sharded as the train step on a ``mesh``."""
    seq = _seq_axis(mesh)

    @torch.no_grad()
    def step(params, tokens):
        return llama.loss_fn(params, tokens, cfg, mesh=mesh, seq_axis=seq,
                             ring=use_ring)

    return step


def evaluate(params, batches, eval_step, mesh: Mesh | None = None) -> dict:
    """Token-weighted mean loss and perplexity over an iterable of token
    batches: each batch's loss weighs its global B·(S-1) predicted tokens
    (the local slices times the mesh's dp and sp), so a short remainder
    batch does not bias the result. The losses stay on the device until
    the end (one synchronisation)."""
    dp = 1 if mesh is None else mesh.axis_size(DP)
    sp = 1 if mesh is None else mesh.axis_size(SP)
    losses, weights = [], []
    for tokens in batches:
        losses.append(eval_step(params, tokens))
        weights.append(tokens.shape[0] * dp * (tokens.shape[1] * sp - 1))
    if not losses:
        raise ValueError("evaluate() got an empty batch iterable")
    w = np.asarray(weights, np.float64)
    ls = torch.stack(losses).double().cpu().numpy()
    mean = float((ls * w).sum() / w.sum())
    return {"loss": mean, "perplexity": float(np.exp(mean)),
            "batches": len(losses)}
