"""Paged decode attention: the token step's attention in one kernel.

=============  ==========================  ===============================
wrapper        replaces (Pallas TPU)       CUDA entry point
=============  ==========================  ===============================
attn_decode    none (XLA's attention)      ocm_attn_decode
                                           (csrc/attn_decode.cu)
=============  ==========================  ===============================

The attention of :func:`~oncilla_tpu_torch.models.kv_paging.paged_token_step`
for one layer: each row's single query token attends over its paged context
(the first ``ctx_len`` keys) and its tail slots through ``tail_len``, within
the sliding window, the query heads of a KV head sharing its keys; the
row's new K/V are first written into its tail slot ``tail_len``, in place.
Every scalar lives in ``meta`` (B, 4) ``[pos, tail_len, ctx_len,
ctx_start]`` on the device, so no launch depends on its values and a CUDA
graph replays the step.

:func:`attn_decode_plain` is the step's plain PyTorch attention (a masked
``llama.grouped_attention`` over the context and the tail, with the masks
of :func:`decode_masks`): the CPU's path and the kernel's reference in
tests. :func:`attn_decode` launches the kernel, or raises on what it cannot
take; its launches are counted in ``attn_decode.launches`` (a plain int,
read and reset with every other kernel's by :func:`.dma.launches` and
:func:`.dma.reset_launches`), at each call: a CUDA graph's replays of a
captured call are not counted.
"""

from __future__ import annotations

import ctypes
import math

import torch

from oncilla_tpu_torch.models import llama
from oncilla_tpu_torch.ops import dma
from oncilla_tpu_torch.ops.dma import CI, LL, VP

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 64, 128)
GROUPS = (2, 4)  # query heads a KV head

# The context is split so that the (row, KV head, split) CTAs fill at most
# WAVES waves of the CTAs the card holds at once (csrc/attn_decode.cu), and
# no split is given fewer than SPLIT_KEYS key slots.
WAVES = 2
SPLIT_KEYS = 128

_SIGNATURES = {
    "ocm_attn_decode": [CI] * 9 + [VP] * 4 + [LL] * 3 + [VP] + [LL] * 3
    + [VP] * 3 + [LL, ctypes.c_float] + [VP] * 4,
    "ocm_attn_decode_occupancy": [CI] * 4 + [ctypes.POINTER(CI)],
}
_SLOTS: dict[tuple, int] = {}


def _load() -> ctypes.CDLL:
    return dma.library("attn_decode.cu", _SIGNATURES)


def slots(q: torch.Tensor, G: int) -> int:
    """The kernel's CTAs that the card of CUDA tensor ``q`` holds at once
    for its dtype, head size and ``G`` (cached)."""
    key = (q.get_device(), q.dtype, q.shape[-1], G)
    n = _SLOTS.get(key)
    if n is None:
        lib, blocks = _load(), CI()
        dma.check(lib, lib.ocm_attn_decode_occupancy(
            key[0], _DTYPES[q.dtype], key[2], G, ctypes.byref(blocks)),
            "attn_decode occupancy")
        n = _SLOTS[key] = max(1, blocks.value) * dma.sm_count(q)
    return n


def splits(keys: int, pairs: int, resident: int) -> int:
    """Splits of a context of ``keys`` key slots (context and tail) for
    ``pairs`` (row, KV head) pairs on a card that holds ``resident`` CTAs
    at once (:func:`slots`)."""
    return max(1, min(WAVES * resident // pairs, keys // SPLIT_KEYS))


def decode_masks(meta: torch.Tensor, C: int, P: int,
                 window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain path's masks: (B, 1, C + P) bool, key valid for the row
    (its first ``ctx_len`` context keys and tail slots through
    ``tail_len``, inside the sliding window), and (B, 1, P, 1) bool, the
    row's tail slot ``tail_len``."""
    dev = meta.device
    pos, tail_len, ctx_len, ctx_start = meta.unbind(1)
    ar_c = torch.arange(C, device=dev)[None, :]
    ar_p = torch.arange(P, device=dev)[None, :]
    valid = torch.cat([ar_c < ctx_len[:, None], ar_p <= tail_len[:, None]], 1)
    if window is not None:
        gpos = torch.cat([ctx_start[:, None] + ar_c,
                          (pos - tail_len)[:, None] + ar_p], 1)
        valid &= gpos > (pos[:, None] - window)
    return valid[:, None, :], (ar_p == tail_len[:, None])[:, None, :, None]


def attn_decode_plain(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, mask, slot):
    """One layer's attention in plain PyTorch. q (B, H, 1, D); kn/vn
    (B, KV, 1, D); k_ctx/v_ctx (B, KV, C, D); tail_k/tail_v (B, KV, P, D),
    the new K/V written into slot ``slot`` in place; ``mask``/``slot`` from
    :func:`decode_masks`. Returns (B, H, 1, D) in q's dtype."""
    tail_k.copy_(torch.where(slot, kn.to(tail_k.dtype), tail_k))
    tail_v.copy_(torch.where(slot, vn.to(tail_v.dtype), tail_v))
    k_all = torch.cat([k_ctx.to(q.dtype), tail_k.to(q.dtype)], 2)
    v_all = torch.cat([v_ctx.to(q.dtype), tail_v.to(q.dtype)], 2)
    return llama.grouped_attention(q, k_all, v_all, mask)


def _aligned(t: torch.Tensor, vec: int) -> bool:
    return t.numel() == 0 or (t.data_ptr() % 16 == 0 and all(
        s % vec == 0 for s in t.stride()[:-1]) and t.stride(-1) == 1)


def _fail(what: str) -> None:
    raise ValueError(f"attn_decode: {what}")


def attn_decode(q, kn, vn, k_ctx, v_ctx, tail_k, tail_v, meta: torch.Tensor,
                window: int | None) -> torch.Tensor:
    """The kernel: :func:`attn_decode_plain`'s result, with its masks read
    from ``meta`` (B, 4) int64 on the device. ``k_ctx``/``v_ctx`` may be
    strided views whose last axis is dense; every other tensor is
    contiguous. Returns a new (B, H, 1, D) tensor in q's dtype; raises
    ValueError on what the kernel does not take, before any launch."""
    B, H, S, D = q.shape
    KV, P = tail_k.shape[1], tail_k.shape[2]
    C = k_ctx.shape[2]
    if q.dtype not in _DTYPES:
        _fail(f"dtype {q.dtype}; the kernel has {sorted(map(str, _DTYPES))}")
    for name, t in (("kn", kn), ("vn", vn), ("k_ctx", k_ctx), ("v_ctx", v_ctx),
                    ("tail_k", tail_k), ("tail_v", tail_v)):
        if t.dtype != q.dtype:
            _fail(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("kn", kn), ("vn", vn), ("k_ctx", k_ctx),
                    ("v_ctx", v_ctx), ("tail_k", tail_k), ("tail_v", tail_v),
                    ("meta", meta)):
        if not t.is_cuda or t.device != q.device:
            _fail(f"{name} on {t.device}; the kernel wants every tensor on "
                  f"one CUDA device")
    if S != 1 or D not in HEAD_DIMS or H % KV or H // KV not in GROUPS:
        _fail(f"q {tuple(q.shape)} over {KV} KV heads: one query token, head "
              f"size in {HEAD_DIMS}, {GROUPS} query heads a KV head")
    if (tuple(kn.shape) != (B, KV, 1, D) or tuple(vn.shape) != (B, KV, 1, D)
            or tuple(v_ctx.shape) != (B, KV, C, D) or tuple(k_ctx.shape[:2]) != (B, KV)
            or k_ctx.shape[3] != D or tuple(tail_v.shape) != (B, KV, P, D)
            or tuple(tail_k.shape) != (B, KV, P, D) or P < 1):
        _fail(f"shapes q {tuple(q.shape)}, kn {tuple(kn.shape)}, vn "
              f"{tuple(vn.shape)}, k_ctx {tuple(k_ctx.shape)}, v_ctx "
              f"{tuple(v_ctx.shape)}, tail_k {tuple(tail_k.shape)}, tail_v "
              f"{tuple(tail_v.shape)} do not agree")
    if meta.dtype != torch.int64 or tuple(meta.shape) != (B, 4) or not meta.is_contiguous():
        _fail(f"meta must be a contiguous ({B}, 4) int64 tensor, got "
              f"{tuple(meta.shape)} {meta.dtype}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("kn", kn), ("vn", vn), ("tail_k", tail_k),
                    ("tail_v", tail_v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            _fail(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("k_ctx", k_ctx), ("v_ctx", v_ctx)):
        if not _aligned(t, vec):
            _fail(f"{name} needs a dense last axis, 16-byte aligned rows "
                  f"(strides {t.stride()})")
    G = H // KV
    nsplit = splits(C + P, B * KV, slots(q, G))
    out = torch.empty_like(q)
    acc = ml = None  # the splits' (acc, max and sum) triples, with more than one
    if nsplit > 1:
        scratch = torch.empty(B * KV * nsplit * G * (D + 2), dtype=torch.float32,
                              device=q.device)
        acc = scratch.data_ptr()
        ml = acc + B * KV * nsplit * G * D * scratch.element_size()
    lib = _load()
    dma.check(lib, lib.ocm_attn_decode(
        q.get_device(), _DTYPES[q.dtype], B, KV, G, D, C, P, nsplit,
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        k_ctx.data_ptr(), *k_ctx.stride()[:3], v_ctx.data_ptr(), *v_ctx.stride()[:3],
        tail_k.data_ptr(), tail_v.data_ptr(), meta.data_ptr(),
        0 if window is None else int(window), 1.0 / math.sqrt(D),
        out.data_ptr(), acc, ml, dma.stream_of(q)), "attn_decode")
    attn_decode.launches += 1 + (nsplit > 1)
    return out


attn_decode.launches = 0
