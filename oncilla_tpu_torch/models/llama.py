"""Llama-style decoder in plain PyTorch: training forward and loss, and
decode.

The counterpart of ``oncilla_tpu/models/llama.py``: the same parameter
names and shapes (weights ``(dim, heads*head_dim)``, layers stacked on a
leading axis), the same ``(B, H, S, Hd)`` attention layout, bf16
activations with fp32 norms, scores and softmax. Attention is written as
plain matmul + softmax over *unexpanded* GQA K/V, as the JAX
``grouped_attention`` is, so the two packages compare like with like.

Differences from the JAX package, by PyTorch idiom: parameters are a plain
dict of tensors on an explicit device; random init takes a
``torch.Generator`` (its numbers differ from ``jax.random``'s, so tests
carry JAX's parameters across with :func:`params_from_jax`), while
:func:`init_params_host` makes the JAX package's numpy draws;
:func:`decode_step` writes the new K/V into the cache in place instead of
returning a functional copy; ``remat`` is ``torch.utils.checkpoint``; and
the loops the JAX package writes as ``lax.scan`` are Python loops (eager
launches are asynchronous, so no host synchronisation sits in them).

Sharded training (``mesh``): the JAX package hands GSPMD global arrays and
lets it insert the collectives; here each process holds its shards under
``train.param_specs`` and the collectives are written out
(:mod:`oncilla_tpu_torch.parallel.collectives`). Under ``tp`` the
column-split products (wq/wk/wv, w_gate/w_up, lm_head) take their input
through ``copy`` and the row-split ones (wo, w_down) end in ``psum`` (the
Megatron pair); ``embed`` is a vocab-split lookup summed over ``tp``; the
cross entropy is vocab-parallel (the max and the sum of exponentials reduced
over ``tp``). Under a sequence axis the tokens are this process's chunk:
RoPE positions are global, attention is the ring
(:mod:`oncilla_tpu_torch.parallel.ring_attention`, or the K/V gathered
over the axis without ``ring``), the last token of a chunk is scored
against the first of the next, and the loss is the mean over the global
B·(S-1) predicted tokens, summed over the data axes. On a mesh of one
every path is the one-device code.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from oncilla_tpu_torch.parallel import collectives as col
from oncilla_tpu_torch.parallel.mesh import DP, TP
from oncilla_tpu_torch.utils.platform import resolve_device

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the JAX package ("bfloat16") as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    ffn_hidden: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # Sliding-window attention: each token attends to at most its last
    # `window` positions. None = full causal attention.
    window: int | None = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny() -> "LlamaConfig":
        """Test-size config."""
        return LlamaConfig(
            vocab=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_hidden=128, max_seq=128, dtype="float32",
        )

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        """Llama-3-8B geometry (BASELINE.md config 5)."""
        return LlamaConfig(
            vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            ffn_hidden=14336, max_seq=8192, rope_theta=500000.0,
        )

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        """Mistral-7B v0.1 geometry: the sliding-window shape (v0.2 dropped
        the window and raised rope_theta)."""
        return LlamaConfig(
            vocab=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            ffn_hidden=14336, max_seq=8192, rope_theta=10000.0, window=4096,
        )


LAYER_KEYS = (
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln_attn", "ln_mlp"
)


def param_spec(cfg: LlamaConfig) -> dict:
    """{name: (shape, init_scale | None)} for every weight; None means a
    ones-initialised fp32 norm gain (the JAX package's spec)."""
    L, D, H, KV, Hd, Fh = (
        cfg.n_layers, cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
        cfg.ffn_hidden,
    )
    s_in = 1.0 / np.sqrt(D)
    s_out = 1.0 / np.sqrt(2 * L * D)
    return {
        "embed": ((cfg.vocab, D), 1.0),
        "wq": ((L, D, H * Hd), s_in),
        "wk": ((L, D, KV * Hd), s_in),
        "wv": ((L, D, KV * Hd), s_in),
        "wo": ((L, H * Hd, D), s_out),
        "w_gate": ((L, D, Fh), s_in),
        "w_up": ((L, D, Fh), s_in),
        "w_down": ((L, Fh, D), s_out),
        "ln_attn": ((L, D), None),
        "ln_mlp": ((L, D), None),
        "ln_out": ((D,), None),
        "lm_head": ((D, cfg.vocab), s_in),
    }


def init_from_spec(spec: dict, dtype, generator: torch.Generator | None = None,
                   device=None, seed: int = 0, keep=None) -> dict:
    """Scaled-normal init of a {name: (shape, scale | None)} spec on
    ``device`` from ``generator`` (one on that device, seeded with
    ``seed``, when not given); None is a ones-initialised fp32 norm gain.
    Shared by the dense and MoE families. Every leaf of rank 3 or more is
    drawn one layer at a time, so the fp32 draw never holds a whole
    stacked leaf (a Mixtral expert leaf is 7.5 GB in fp32). ``keep(name,
    leaf)``, when given, is stored in place of each drawn leaf (a sharded
    state keeps its slice): only one whole leaf is held at a time."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(dtype)
    out = {}
    for name, (shape, scale) in spec.items():
        if scale is None:
            t = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            t = torch.empty(shape, dtype=dt, device=dev)
            for part in (t if len(shape) >= 3 else [t]):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32, device=dev) * scale)
        out[name] = t if keep is None else keep(name, t)
        del t
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                device=None, seed: int = 0, keep=None) -> dict:
    """:func:`init_from_spec` of the dense family's :func:`param_spec`."""
    return init_from_spec(param_spec(cfg), cfg.dtype, generator, device, seed,
                          keep)


def init_params_host(seed: int, cfg: LlamaConfig, device=None, keep=None) -> dict:
    """The JAX package's ``init_params_host``: the same numpy draws in the
    same order, so both packages start from identical weights, moved to
    ``device`` (``keep`` as in :func:`init_from_spec`)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dt = torch_dtype(cfg.dtype)
    out = {}
    for name, (shape, scale) in param_spec(cfg).items():
        if scale is None:
            t = torch.ones(shape, dtype=torch.float32)
        else:
            # numpy computes the product in float64 (a float32 array times a
            # numpy float64); it is rounded to float32, then to the weight
            # dtype, as the JAX package's astype rounds it.
            x = rng.standard_normal(shape, dtype=np.float32) * scale
            t = torch.from_numpy(x.astype(np.float32))
        if keep is not None:
            t = keep(name, t)
        out[name] = t.to(dev, dt if scale is not None else torch.float32)
    return out


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A numpy array of any dtype numpy holds, bf16 included, as a tensor
    (a copy) on ``device``."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def params_from_jax(np_params: dict, device=None) -> dict:
    """The JAX package's parameters, handed over as numpy arrays, as
    tensors on ``device``."""
    dev = resolve_device(device)
    return {name: tensor_from_numpy(arr, dev) for name, arr in np_params.items()}


def layer_params(params: dict, i: int) -> dict:
    return {k: params[k][i] for k in LAYER_KEYS}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, H, S, Hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    ))
    if positions.ndim == 1:
        ang = (positions[:, None].float() * freqs[None, :])[None, None]
    else:
        ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def grouped_attention(q, k, v, mask=None):
    """Dense attention with unexpanded GQA K/V, fp32 scores and softmax.

    q: (B, H, Sq, D); k/v: (B, KV, Sk, D) with KV dividing H. ``mask``:
    None (every key given is attended: the sliced callers), (Sq, Sk) bool,
    or (B, Sq, Sk) bool (each row its own validity: batched serving).
    Masked scores are set to -1e30, as in the JAX package, not -inf: a
    fully masked row (a bucket-padded batch row) gets a uniform softmax and
    finite values, and a masked key among valid ones a weight of exactly 0
    in fp32. Returns (B, H, Sq, D) in q's dtype."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    q5 = q.reshape(B, KV, H // KV, Sq, D).float()
    scale = 1.0 / np.sqrt(D)
    s = torch.matmul(q5, k.float().unsqueeze(2).transpose(-1, -2)) * scale
    if mask is not None:
        m = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
        s = s.masked_fill(~m, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v.float().unsqueeze(2))
    return o.reshape(B, H, Sq, D).to(q.dtype)


def causal_mask(sq: int, sk: int, window: int | None = None,
                device=None) -> torch.Tensor:
    """Lower-triangular (sq, sk) bool mask aligned to the *end* of the key
    axis; with ``window``, each query also sees at most its last ``window``
    keys: key j attends to query i iff i-window < j-(sk-sq) <= i."""
    ones = torch.ones((sq, sk), dtype=torch.bool, device=device)
    m = torch.tril(ones, diagonal=sk - sq)
    if window is not None:
        m &= torch.triu(ones, diagonal=sk - sq - window + 1)
    return m


def block(cfg: LlamaConfig, x, lp, positions, attend, mlp=None, tp=None):
    """One transformer block. x: (B, S, D); ``attend(q, kn, vn)`` gets the
    rotary-embedded q (B, H, S, Hd) and unexpanded K/V (B, KV, S, Hd) and
    returns (B, H, S, Hd). ``mlp(h)`` (if given) replaces the dense SwiGLU
    FFN on the rmsnorm'd residual (the MoE family's hook). ``tp``: the
    tensor-parallel group, when ``lp`` holds this process's heads and ffn
    columns (the head counts follow the weights' widths)."""
    B, S, _ = x.shape
    Hd = cfg.head_dim

    h = col.copy(rmsnorm(x, lp["ln_attn"], cfg.norm_eps), tp)
    q = (h @ lp["wq"]).reshape(B, S, -1, Hd)
    kn = (h @ lp["wk"]).reshape(B, S, -1, Hd)
    vn = (h @ lp["wv"]).reshape(B, S, -1, Hd)
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta)
    kn = rope(kn.transpose(1, 2), positions, cfg.rope_theta)
    vn = vn.transpose(1, 2)
    attn = attend(q, kn, vn)
    attn = attn.transpose(1, 2).reshape(B, S, -1)
    x = x + col.psum(attn @ lp["wo"], tp)

    h = rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    if mlp is not None:
        return x + mlp(h)
    h = col.copy(h, tp)
    y = (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    return x + col.psum(y, tp)


def final_logits(params, x, cfg: LlamaConfig) -> torch.Tensor:
    x = rmsnorm(x, params["ln_out"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def seq_sharded(mesh, seq_axis) -> bool:
    return seq_axis is not None and mesh is not None and \
        mesh.axis_size(seq_axis) > 1


def make_attend(S: int, mesh=None, seq_axis: str | None = None,
                window: int | None = None, device=None, ring: bool = True):
    """The dense-vs-ring attention dispatch shared by the model families.
    With ``mesh`` + ``seq_axis`` (an axis of size > 1) the queries, keys and
    values are this process's chunk of S of the sequence, and the callback
    runs ring attention over the axis (``ring`` False: the K/V chunks are
    all-gathered and each query chunk attends to them, GSPMD's layout when
    the JAX step runs without the ring); else causal dense attention over S
    keys. ``window`` band-limits every path, from global positions."""
    if seq_sharded(mesh, seq_axis):
        from oncilla_tpu_torch.parallel.ring_attention import ring_attention

        if ring:
            def attend(q, kn, vn):
                return ring_attention(q, kn, vn, mesh, axis_name=seq_axis,
                                      causal=True, window=window)
            return attend
        n, me = mesh.axis_size(seq_axis), mesh.axis_index(seq_axis)
        qg = me * S + torch.arange(S, device=device)[:, None]
        kg = torch.arange(n * S, device=device)[None, :]
        gmask = kg <= qg
        if window is not None:
            gmask &= kg > qg - window
        group = mesh.group(seq_axis)

        def attend(q, kn, vn):
            return grouped_attention(q, col.all_gather(kn, 2, group),
                                     col.all_gather(vn, 2, group), gmask)
        return attend
    mask = causal_mask(S, S, window, device=device)

    def attend(q, kn, vn):
        return grouped_attention(q, kn, vn, mask)

    return attend


def _save_weight_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the 2-D weight products
    (``h @ w`` of a (B, S, D) activation lowers to ``aten.mm``), recompute
    the rest, the attention ``bmm``s among it. JAX's
    ``dots_with_no_batch_dims_saveable`` draws the same line: its weight
    einsums have no batch dimension, the attention einsums do."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, remat):
    """``remat`` placement: False stores every block activation; True
    checkpoints the whole block (backward recomputes it); ``"dots"``
    checkpoints it but keeps the weight products' outputs
    (:func:`_save_weight_products`)."""
    if remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_weight_products)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    if remat:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return fn


def tp_group(mesh):
    """The tensor-parallel group of ``mesh`` (None without one)."""
    return None if mesh is None else mesh.group(TP)


def embed(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, mesh=None):
    """The token embeddings in the activation dtype. Under ``tp`` the table
    is split by vocab rows (``P(TP, None)``): each process looks up the ids
    in its rows, zeros the rest, and the sum over ``tp`` is the lookup."""
    tp = tp_group(mesh)
    table = params["embed"]
    if tp is None:
        return table[tokens].to(torch_dtype(cfg.dtype))
    rows = table.shape[0]
    local = tokens.long() - mesh.axis_index(TP) * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].masked_fill(~mine[..., None], 0)
    return col.psum(x, tp).to(torch_dtype(cfg.dtype))


def positions_of(S: int, mesh, seq_axis, device) -> torch.Tensor:
    """Global positions of this process's S tokens: chunk i of a sharded
    sequence starts at i·S."""
    start = mesh.axis_index(seq_axis) * S if seq_sharded(mesh, seq_axis) else 0
    return torch.arange(start, start + S, device=device)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
                   mesh=None, seq_axis: str | None = None,
                   remat=False, ring: bool = True) -> torch.Tensor:
    """Final hidden states (B, S, D), pre-``ln_out``; ``remat`` per
    :func:`_remat_wrap`. Each stacked leaf is unbound once, so its
    gradient is one stack of the layers' gradients. With ``mesh``, params
    and tokens are this process's shards (module docstring)."""
    B, S = tokens.shape
    x = embed(params, tokens, cfg, mesh)
    positions = positions_of(S, mesh, seq_axis, tokens.device)
    attend = make_attend(S, mesh, seq_axis, window=cfg.window,
                         device=tokens.device, ring=ring)
    tp = tp_group(mesh)

    def one_block(x, lp):
        return block(cfg, x, lp, positions, attend, tp=tp)

    one_block = _remat_wrap(one_block, remat)
    layers = {k: params[k].unbind(0) for k in LAYER_KEYS}
    for i in range(cfg.n_layers):
        x = one_block(x, {k: layers[k][i] for k in LAYER_KEYS})
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            **kw) -> torch.Tensor:
    """fp32 logits for a token batch (B, S) (see :func:`forward_hidden`)."""
    return final_logits(params, forward_hidden(params, tokens, cfg, **kw), cfg)


def blocked_cross_entropy(params: dict, x: torch.Tensor, targets: torch.Tensor,
                          cfg: LlamaConfig, block: int = 512) -> torch.Tensor:
    """Next-token CE without the (B, S, V) logits: the vocab head runs on
    chunks of ``block`` positions, each chunk's logits and NLL under
    ``checkpoint``, so backward recomputes that chunk's logits. ``x`` is
    the pre-``ln_out`` hidden (B, S, D), ``targets`` (B, S-1); the last
    chunk is zero-padded and its padding masked, as in the JAX package."""
    xh = rmsnorm(x, params["ln_out"], cfg.norm_eps)[:, :-1]
    B, T, _ = xh.shape
    pad = (-T) % block
    mask = (torch.arange(T + pad, device=x.device) < T).expand(B, T + pad)
    if pad:
        xh = F.pad(xh, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    targets = targets.long()

    def chunk_nll(xc, tc, mc):
        logits = (xc @ params["lm_head"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, tc[..., None])[..., 0]
        return torch.sum((lse - tgt) * mc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, T + pad, block):
        sl = slice(lo, lo + block)
        total = total + checkpoint(chunk_nll, xh[:, sl], targets[:, sl],
                                   mask[:, sl], use_reentrant=False)
    return total / (B * T)


def _token_nll(xh: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """Per-token NLL (fp32) of the normed hidden ``xh`` (B, T, D) against
    ``targets`` (B, T). Under ``tp`` the head holds this process's vocab
    columns: the max and the sum of exponentials are reduced over ``tp``,
    and the target's logit comes from the process holding its column."""
    tp = tp_group(mesh)
    targets = targets.long()
    if tp is None:
        logits = (xh @ lm_head).float()
        return torch.logsumexp(logits, dim=-1) - \
            logits.gather(-1, targets[..., None])[..., 0]
    logits = (col.copy(xh, tp) @ lm_head).float()
    cols = logits.shape[-1]
    top = col.pmax(logits.amax(dim=-1), tp)
    lse = torch.log(col.psum(torch.exp(logits - top[..., None]).sum(-1), tp)) + top
    local = targets - mesh.axis_index(TP) * cols
    mine = (local >= 0) & (local < cols)
    tgt = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    return lse - col.psum(tgt.masked_fill(~mine, 0.0), tp)


def data_axes(mesh, seq_axis) -> tuple:
    """The axes the token batch is split over: ``dp`` (when the mesh has
    it) and the sequence axis."""
    axes = (DP,) if mesh.axis_size(DP) > 1 else ()
    return axes + ((seq_axis,) if seq_sharded(mesh, seq_axis) else ())


def sharded_cross_entropy(params: dict, x: torch.Tensor, tokens: torch.Tensor,
                          cfg: LlamaConfig, mesh, seq_axis=None,
                          ce_block: int | None = None) -> torch.Tensor:
    """Mean next-token CE over the global batch from this process's hidden
    ``x`` (B, S, D) and tokens (B, S): the last token of a sequence chunk
    is scored against the first of the next (sent back along the sequence
    axis), the sum of NLLs is reduced over the data axes and divided by the
    global B·(S-1). ``ce_block`` chunks the head as
    :func:`blocked_cross_entropy` does. Replicated on every process."""
    B, S = tokens.shape
    n = mesh.axis_size(seq_axis) if seq_sharded(mesh, seq_axis) else 1
    targets = tokens[:, 1:]
    T = S - 1
    if n > 1:
        nxt = col.exchange(tokens[:, :1].contiguous(), mesh, seq_axis,
                           [(i, i - 1) for i in range(1, n)], like=tokens[:, :1])
        targets = torch.cat([targets, nxt], dim=1)
        if mesh.axis_index(seq_axis) < n - 1:
            T = S
    xh = rmsnorm(x, params["ln_out"], cfg.norm_eps)[:, :T]
    targets = targets[:, :T]
    if ce_block is None:
        total = _token_nll(xh, params["lm_head"], targets, mesh).sum()
    else:
        def chunk(xc, tc):
            return _token_nll(xc, params["lm_head"], tc, mesh).sum()

        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, T, ce_block):
            sl = slice(lo, lo + ce_block)
            total = total + checkpoint(chunk, xh[:, sl], targets[:, sl],
                                       use_reentrant=False)
    axes = data_axes(mesh, seq_axis)
    total = col.psum(total, mesh.group(*axes))
    return total / (B * mesh.axis_size(DP) * (S * n - 1))


def loss_fn(params, tokens, cfg: LlamaConfig, *, ce_block: int | None = None,
            mesh=None, **kw) -> torch.Tensor:
    """Mean next-token cross entropy. ``ce_block`` switches to
    :func:`blocked_cross_entropy`. With a ``mesh`` of more than one
    process, params and tokens are this process's shards and the result is
    the global loss on every process (:func:`sharded_cross_entropy`)."""
    if mesh is not None and mesh.size > 1:
        x = forward_hidden(params, tokens, cfg, mesh=mesh, **kw)
        return sharded_cross_entropy(params, x, tokens, cfg, mesh,
                                     kw.get("seq_axis"), ce_block)
    if ce_block is not None:
        x = forward_hidden(params, tokens, cfg, **kw)
        return blocked_cross_entropy(params, x, tokens[:, 1:], cfg,
                                     block=ce_block)
    logits = forward(params, tokens, cfg, **kw)[:, :-1]
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return -ll.mean()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next-token ids (B,) from logits (B, vocab)."""
    return torch.argmax(logits, dim=-1)


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Next-token ids (B,) from logits (B, vocab): the argmax at
    ``temperature`` 0, else one draw from softmax(logits / temperature)
    taken with ``generator`` (on the logits' device). The JAX package's
    sampler (llama.py:456) draws from ``jax.random.categorical``; its
    stream is not reproduced, only the distribution."""
    if temperature == 0.0:
        return greedy(logits)
    probs = torch.softmax(logits.float() / float(temperature), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_step(
    params: dict,
    token: torch.Tensor,      # (B,) current token ids
    pos: int,                 # current position
    kv_cache: tuple,          # (k, v) each (L, B, KV, T, Hd)
    cfg: LlamaConfig,
    *,
    layer_params_fn=layer_params,
    mlp_of=None,
):
    """Single-token decode over a contiguous cache: returns
    (logits (B, vocab) fp32, kv_cache). This token's K/V are written into
    the cache at ``pos`` in place.

    Attention reads the slice of keys that are valid, ``[lo, pos]`` (``lo``
    the start of the sliding window, else 0), where the JAX package masks a
    static-length cache: eager PyTorch needs no static shapes, and the paged
    decoder attends over the same slice, so the two do the same arithmetic
    on the same shapes.

    ``layer_params_fn`` / ``mlp_of`` are the family hooks: the MoE family
    passes its layer slicer and an ``mlp_of(lp) -> mlp`` factory, so the
    same cache machinery decodes a sparse-FFN model
    (:func:`oncilla_tpu_torch.models.moe.decode_step`)."""
    pos = int(pos)
    dev = token.device
    x = params["embed"][token][:, None, :].to(torch_dtype(cfg.dtype))
    k_cache, v_cache = kv_cache
    positions = torch.tensor([pos], device=dev)
    lo = 0 if cfg.window is None else max(0, pos - cfg.window + 1)

    for i in range(cfg.n_layers):
        lp = layer_params_fn(params, i)

        def attend(q, kn, vn, i=i):
            k_cache[i, :, :, pos] = kn[:, :, 0].to(k_cache.dtype)
            v_cache[i, :, :, pos] = vn[:, :, 0].to(v_cache.dtype)
            return grouped_attention(
                q, k_cache[i, :, :, lo:pos + 1].to(q.dtype),
                v_cache[i, :, :, lo:pos + 1].to(q.dtype),
            )

        x = block(cfg, x, lp, positions, attend,
                  mlp=mlp_of(lp) if mlp_of else None)

    return final_logits(params, x, cfg)[:, 0], (k_cache, v_cache)


def make_kv_cache(cfg: LlamaConfig, batch: int, dtype=None, device=None):
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def decode_loop(params, tokens: torch.Tensor, kv_cache: tuple,
                cfg: LlamaConfig, *, step_fn=None):
    """Teacher-forced decode of ``tokens`` (B, N) from position 0, one
    :func:`decode_step` a position (``step_fn`` swaps in another family's):
    returns (logits (B, N, vocab), kv_cache)."""
    step_fn = step_fn or decode_step
    logits = []
    for pos in range(tokens.shape[1]):
        step_logits, kv_cache = step_fn(params, tokens[:, pos], pos, kv_cache,
                                        cfg)
        logits.append(step_logits)
    return torch.stack(logits, dim=1), kv_cache


@torch.no_grad()
def generate(params, prompt: torch.Tensor, kv_cache: tuple, cfg: LlamaConfig,
             steps: int, *, generator: torch.Generator | None = None,
             temperature: float = 0.0, step_fn=None):
    """Prefill over ``prompt`` (B, P), then ``steps`` sampled tokens
    (greedy at ``temperature`` 0, else drawn with ``generator``). Returns
    ((B, steps) ids, kv_cache); the cache covers the prompt and the first
    steps-1 samples, so decoding goes on from position P + steps - 1."""
    P = prompt.shape[1]
    step_fn = step_fn or decode_step
    logits, kv_cache = decode_loop(params, prompt, kv_cache, cfg,
                                   step_fn=step_fn)
    tok = sample_token(logits[:, -1], temperature, generator).to(prompt.dtype)
    out = [tok]
    for pos in range(P, P + steps - 1):
        step_logits, kv_cache = step_fn(params, tok, pos, kv_cache, cfg)
        tok = sample_token(step_logits, temperature, generator).to(prompt.dtype)
        out.append(tok)
    return torch.stack(out, dim=1), kv_cache
