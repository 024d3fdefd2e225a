"""Ring attention: exact attention over sequence-sharded Q/K/V.

The counterpart of ``oncilla_tpu/parallel/ring_attention.py``. Each process
holds one sequence chunk of Q, K and V; the K/V chunks travel around the
ring of the sequence axis (:func:`~oncilla_tpu_torch.parallel.collectives.
ppermute` over ``dist.batch_isend_irecv``) while a flash-style online
softmax accumulates the exact result in float32, whatever the activations'
dtype. K/V stay unexpanded (GQA): the ring carries ``n_kv_heads`` heads, a
group's worth fewer bytes than the query heads, and each block works on
grouped heads. ``window`` composes sliding-window attention with the ring,
from global positions.

What differs from the JAX module, by PyTorch idiom: the ring is a Python
loop of ``n`` blocks, and its last rotation, whose result the JAX loop
carries out and drops, is not sent; gradients cross the ring through
``ppermute``'s backward (the inverse rotation), as ``jax.grad`` transposes
the JAX ``ppermute``. :func:`ring_attention` takes this process's chunks,
where the JAX function takes the global arrays and ``shard_map``s them.
"""

from __future__ import annotations

import math

import torch

from oncilla_tpu_torch.parallel.collectives import ppermute, ring_perm

_NEG = -1e30


def _block_attend(q5, k, v, scale: float, mask):
    """One (Q-chunk x K-chunk) block with grouped KV heads, fp32 math.

    q5: (B, KV, G, Sq, D); k/v: (B, KV, Sk, D); mask: (Sq, Sk) bool or None.
    Returns (o, row_max, row_sum) for the online-softmax merge, all fp32."""
    s = torch.matmul(q5.float(), k.float().unsqueeze(2).transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG)
    m = s.amax(dim=-1)                                     # (B, KV, G, Sq)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        # A fully masked row has m == _NEG and p == 1 everywhere; zero it.
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    o = torch.matmul(p, v.float().unsqueeze(2))
    return o, m, l


def ring_attention_shard(q, k, v, *, axis_name: str, causal: bool = True,
                         window: int | None = None, mesh=None):
    """This process's ring attention over ``axis_name`` of ``mesh``.

    q: (B, H, S_local, D); k/v: (B, KV, S_local, D) with KV dividing H; the
    chunk of sequence index i along the axis holds global positions
    [i·S_local, (i+1)·S_local). ``window`` band-limits each query to its
    last ``window`` global positions. Returns (B, H, S_local, D) in q's
    dtype."""
    if window is not None and not causal:
        raise ValueError(
            "window requires causal=True (the band is defined over past "
            "positions; a non-causal window is ambiguous)")
    n = mesh.axis_size(axis_name)
    me = mesh.axis_index(axis_name)
    B, H, s_local, D = q.shape
    KV = k.shape[1]
    q5 = q.reshape(B, KV, H // KV, s_local, D)
    scale = 1.0 / math.sqrt(D)
    perm = ring_perm(n)
    ar = torch.arange(s_local, device=q.device)

    o = torch.zeros(q5.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q5.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(q5.shape[:-1], dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        # After i rotations this process holds chunk (me - i) mod n.
        j = (me - i) % n
        mask = None
        if causal or window is not None:
            qg = me * s_local + ar[:, None]
            kg = j * s_local + ar[None, :]
            mask = torch.ones((s_local, s_local), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kg <= qg
            if window is not None:
                mask &= kg > qg - window
        o_blk, m_blk, l_blk = _block_attend(q5, k_cur, v_cur, scale, mask)
        # Online-softmax merge (flash-attention accumulation), fp32.
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        l = l * alpha + l_blk * beta
        o = o * alpha[..., None] + o_blk * beta[..., None]
        m = m_new
        if i < n - 1:
            k_cur = ppermute(k_cur, mesh, axis_name, perm)
            v_cur = ppermute(v_cur, mesh, axis_name, perm)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, s_local, D).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   window: int | None = None) -> torch.Tensor:
    """Exact attention with Q/K/V sequence-sharded over ``axis_name``:
    q (B, H, S_local, D), k/v (B, KV, S_local, D), this process's chunks.
    Differentiable (see :func:`ring_attention_shard`)."""
    return ring_attention_shard(q, k, v, axis_name=axis_name, causal=causal,
                                window=window, mesh=mesh)
