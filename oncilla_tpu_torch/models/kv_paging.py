"""KV-cache paging through OCM handles (BASELINE.md config 5), in PyTorch.

The counterpart of ``oncilla_tpu/models/kv_paging.py``: decode keeps a
fixed local tail buffer of one page; each full page is shipped into an OCM
allocation with a one-sided ``put``, and attention runs over the paged
context (re-read with one-sided ``get``s when ``refetch``) plus the tail.
On a CUDA context every page put lands on the ``write_rows`` kernel and
every page get on ``read_rows`` (a page is far above the 1 MiB kernel
threshold at real widths).

PyTorch runs eagerly, so the JAX package's shape-bucketed jit step becomes
a plain function (:func:`paged_decode_step`) that writes this token's K/V
into the tail buffer in place. The masked, fixed-shape formulation of the
JAX jit steps (:func:`paged_token_step`, :func:`paged_decode_batch_step`,
:func:`paged_decode_page`) keeps every shape static and every per-row
scalar on the device, so the step can be captured in a CUDA graph
(:mod:`.graphs`): the serving engine's batched step and the page-fused
modes of the kv_decode harness replay it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hbm import from_bytes, to_bytes
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.models import llama
from oncilla_tpu_torch.models.graphs import StepGraphs
from oncilla_tpu_torch.models.llama import LlamaConfig, torch_dtype
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER


def page_bytes(cfg: LlamaConfig, page_tokens: int, dtype: str,
               batch: int = 1) -> int:
    """Bytes of one KV page: K and V of every layer for ``page_tokens``."""
    return (2 * cfg.n_layers * batch * cfg.n_kv_heads * page_tokens
            * cfg.head_dim * torch_dtype(dtype).itemsize)


@dataclass
class PagedKVCache:
    """KV pages for one decode session.

    ``backend`` is an :class:`~oncilla_tpu_torch.core.context.Ocm` context.
    Page layout: K and V of one page packed in one allocation,
    (2, L, B, KV, page_tokens, Hd) bitcast to bytes.
    """

    backend: object
    cfg: LlamaConfig
    batch: int
    page_tokens: int = 128
    kind: OcmKind = OcmKind.REMOTE_DEVICE
    dtype: str = "float32"
    pages: list[OcmAlloc] = field(default_factory=list)
    # Registered receive buffer for host-kind fetches (pinned on a CUDA
    # context), grown geometrically and reused across fetch_pages calls.
    _recvbuf: torch.Tensor | None = field(default=None, repr=False,
                                          compare=False)

    @property
    def page_shape(self) -> tuple:
        c = self.cfg
        return (2, c.n_layers, self.batch, c.n_kv_heads, self.page_tokens,
                c.head_dim)

    @property
    def page_bytes(self) -> int:
        return page_bytes(self.cfg, self.page_tokens, self.dtype, self.batch)

    @property
    def tokens_paged(self) -> int:
        return len(self.pages) * self.page_tokens

    def store_page(self, k_page: torch.Tensor, v_page: torch.Tensor) -> OcmAlloc:
        """Ship one completed page (one-sided put). k/v: (L, B, KV, P, Hd)."""
        packed = torch.stack([k_page, v_page]).to(torch_dtype(self.dtype))
        assert tuple(packed.shape) == self.page_shape, (packed.shape,
                                                        self.page_shape)
        with GLOBAL_TRACER.span("kv_store_page", nbytes=self.page_bytes):
            h = self.backend.alloc(self.page_bytes, self.kind)
            self.backend.put(h, to_bytes(packed), 0)
        self.pages.append(h)
        return h

    def _recv_slots(self, npages: int) -> torch.Tensor | None:
        """One reusable receive buffer with a page-sized slot per page, for
        host kinds (LOCAL_HOST, and REMOTE_HOST pages off the wire); None
        for device kinds (their gets stay on the card)."""
        if self.kind not in (OcmKind.REMOTE_HOST, OcmKind.LOCAL_HOST):
            return None
        need = self.page_bytes * npages
        if self._recvbuf is None or self._recvbuf.numel() < need:
            have = self._recvbuf.numel() if self._recvbuf is not None else 0
            cap = max(need, 2 * max(have, self.page_bytes))
            self._recvbuf = torch.empty(
                cap, dtype=torch.uint8,
                pin_memory=self.backend.device.type == "cuda",
            )
        return self._recvbuf

    def fetch_pages(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Gather every page back (one-sided gets) and concatenate along the
        token axis: (L, B, KV, tokens_paged, Hd) x2, on the context's
        device. Host-kind pages land in the receive buffer and go up to the
        device in one transfer."""
        if not self.pages:
            return None
        nb = self.page_bytes
        dt = torch_dtype(self.dtype)
        slots = self._recv_slots(len(self.pages))
        with GLOBAL_TRACER.span("kv_fetch_pages", nbytes=nb * len(self.pages)):
            if slots is None:
                raws = [self.backend.get(h, nb, 0) for h in self.pages]
            else:
                for i, h in enumerate(self.pages):
                    self.backend.get(h, out=slots[i * nb:(i + 1) * nb])
                up = slots[:nb * len(self.pages)].to(self.backend.device)
                raws = up.split(nb)
            packed = [from_bytes(r, self.page_shape, dt) for r in raws]
            return (torch.cat([p[0] for p in packed], dim=3),
                    torch.cat([p[1] for p in packed], dim=3))

    def drop_oldest(self) -> None:
        """Free the oldest page (sliding-window eviction); the caller tracks
        the global position of the first retained page (``ctx_start``)."""
        self.backend.free(self.pages.pop(0))

    def free(self) -> None:
        for h in self.pages:
            self.backend.free(h)
        self.pages.clear()


def paged_decode_step(
    params: dict,
    token: torch.Tensor,    # (B,) current token ids
    pos: int,
    tail_len: int,
    ctx_start: int,
    k_ctx: torch.Tensor,    # (L, B, KV, C, Hd) paged context; C may be 0
    v_ctx: torch.Tensor,
    tail_k: torch.Tensor,   # (L, B, KV, P, Hd) local tail, updated in place
    tail_v: torch.Tensor,
    cfg: LlamaConfig,
):
    """One paged-decode token (``_paged_token`` of the JAX package). The
    keys are the paged context (global positions ``ctx_start ..``) followed
    by the tail slots through this token's slot ``tail_len``: the positions
    ``[ctx_start, pos]`` in order. Attention reads the slice of them inside
    the sliding window, where the JAX package masks a fixed-size tail, so
    it runs the same arithmetic on the same shapes as the unpaged
    :func:`llama.decode_step`. Writes this token's K/V into the tail at
    ``tail_len`` and returns (logits (B, vocab), tail_k, tail_v)."""
    dev = token.device
    x = params["embed"][token][:, None, :].to(torch_dtype(cfg.dtype))
    positions = torch.tensor([pos], device=dev)
    assert ctx_start + k_ctx.shape[3] == pos - tail_len, "paged context gap"
    drop = 0 if cfg.window is None else max(0, pos - cfg.window + 1 - ctx_start)

    for i in range(cfg.n_layers):
        def attend(q, kn, vn, i=i):
            tail_k[i, :, :, tail_len] = kn[:, :, 0].to(tail_k.dtype)
            tail_v[i, :, :, tail_len] = vn[:, :, 0].to(tail_v.dtype)
            k_all = torch.cat([k_ctx[i].to(q.dtype),
                               tail_k[i, :, :, :tail_len + 1].to(q.dtype)], dim=2)
            v_all = torch.cat([v_ctx[i].to(q.dtype),
                               tail_v[i, :, :, :tail_len + 1].to(q.dtype)], dim=2)
            return llama.grouped_attention(q, k_all[:, :, drop:], v_all[:, :, drop:])

        x = llama.block(cfg, x, llama.layer_params(params, i), positions,
                        attend)

    return llama.final_logits(params, x, cfg)[:, 0], tail_k, tail_v


def paged_token_step(
    params: dict,
    tokens: torch.Tensor,   # (B,) current token ids
    meta: torch.Tensor,     # (B, 4) [pos, tail_len, ctx_len, ctx_start]
    k_ctx: torch.Tensor,    # (L, B, KV, C, Hd) paged context; C may be 0
    v_ctx: torch.Tensor,
    tail_k: torch.Tensor,   # (L, B, KV, P, Hd) tails, updated in place
    tail_v: torch.Tensor,
    cfg: LlamaConfig,
):
    """One paged-decode token for B rows on fixed shapes: the JAX package's
    ``_paged_token`` (kv_paging.py:260) with the per-row ``meta`` of its
    batched step (:320). Row b attends over its first ``ctx_len`` context
    keys (global positions from ``ctx_start``) and its tail slots through
    ``tail_len``, within the sliding window; every other key is masked
    (-1e30). Row b's new K/V go into its tail slot ``tail_len``, in place.
    Every scalar lives in ``meta`` on the device and no shape depends on
    it, so the step is the same kernels at every position: what a CUDA
    graph captures. Returns (logits (B, vocab) fp32, tail_k, tail_v)."""
    dev = tokens.device
    P, C = tail_k.shape[3], k_ctx.shape[3]
    pos, tail_len, ctx_len, ctx_start = meta.unbind(1)
    x = params["embed"][tokens][:, None, :].to(torch_dtype(cfg.dtype))
    ar_c = torch.arange(C, device=dev)[None, :]
    ar_p = torch.arange(P, device=dev)[None, :]
    valid = torch.cat([ar_c < ctx_len[:, None], ar_p <= tail_len[:, None]], 1)
    if cfg.window is not None:
        gpos = torch.cat([ctx_start[:, None] + ar_c,
                          (pos - tail_len)[:, None] + ar_p], 1)
        valid &= gpos > (pos[:, None] - cfg.window)
    mask = valid[:, None, :]                                  # (B, 1, C + P)
    slot = (ar_p == tail_len[:, None])[:, None, :, None]      # (B, 1, P, 1)

    for i in range(cfg.n_layers):
        def attend(q, kn, vn, i=i):
            tail_k[i] = torch.where(slot, kn.to(tail_k.dtype), tail_k[i])
            tail_v[i] = torch.where(slot, vn.to(tail_v.dtype), tail_v[i])
            k_all = torch.cat([k_ctx[i].to(q.dtype), tail_k[i].to(q.dtype)], 2)
            v_all = torch.cat([v_ctx[i].to(q.dtype), tail_v[i].to(q.dtype)], 2)
            return llama.grouped_attention(q, k_all, v_all, mask)

        x = llama.block(cfg, x, llama.layer_params(params, i), pos[:, None],
                        attend)

    return llama.final_logits(params, x, cfg)[:, 0], tail_k, tail_v


def paged_decode_batch_step(
    params: dict,
    tokens: torch.Tensor,   # (B,) current token ids, one per session
    meta: torch.Tensor,     # (B, 4) [pos, tail_len, ctx_len, ctx_start]
    pool_k: torch.Tensor,   # (N, L, KV, P, Hd) resident page pool
    pool_v: torch.Tensor,
    table: torch.Tensor,    # (B, MP) pool row per context page
    tail_k: torch.Tensor,   # (L, B, KV, P, Hd) per-session tails, in place
    tail_v: torch.Tensor,
    cfg: LlamaConfig,
):
    """One decode step for a whole batch of paged sessions
    (``paged_decode_batch_step_jit``, kv_paging.py:320 of the JAX package).
    The pool stacks every distinct resident page once; ``table[b]`` lists
    session b's pages in context order, 0-padded past its ``ctx_len``. The
    gather ``pool[table]`` is part of the step, so a CUDA graph of it takes
    O(B * MP) indices a step, not the context. Padded rows (``ctx_len`` 0,
    ``tail_len`` 0) give finite logits, which the caller discards. Callers
    bucket B, MP and N to powers of two (one graph a bucket). Returns
    (logits (B, vocab), tail_k, tail_v), the tails updated in place."""
    N, L, KV, P, Hd = pool_k.shape
    B, MP = table.shape
    k_ctx = pool_k[table].permute(2, 0, 3, 1, 4, 5).reshape(L, B, KV, MP * P, Hd)
    v_ctx = pool_v[table].permute(2, 0, 3, 1, 4, 5).reshape(L, B, KV, MP * P, Hd)
    return paged_token_step(params, tokens, meta, k_ctx, v_ctx, tail_k,
                            tail_v, cfg)


def bucket_context(k_ctx: torch.Tensor, v_ctx: torch.Tensor,
                   page_tokens: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The paged context (L, B, KV, C, Hd) zero-padded along C to a power
    of two of pages (an empty context stays empty): the context's shape
    buckets, as the batched step buckets its pages, so that a context
    growing a page at a time meets O(log pages) shapes and a graph cache
    (:mod:`.graphs`) keeps as many captures. The masked steps read only
    the first ``ctx_len`` keys, which the caller passes."""
    pages = k_ctx.shape[3] // page_tokens
    pad = (pages if pages <= 1 else 1 << (pages - 1).bit_length()) - pages
    if pad == 0:
        return k_ctx, v_ctx
    z = k_ctx.new_zeros(k_ctx.shape[:3] + (pad * page_tokens,) + k_ctx.shape[4:])
    return torch.cat([k_ctx, z], 3), torch.cat([v_ctx, z], 3)


def _page_metas(meta, B: int, P: int, ctx_len: int, device) -> torch.Tensor:
    """(P, B, 4) per-token rows of one page decoded from an empty tail:
    token j at position pos0 + j, tail_len j, the first ``ctx_len``
    context keys valid."""
    pos0, ctx_start = (int(m) for m in meta)
    j = torch.arange(P)
    rows = torch.stack([pos0 + j, j, torch.full_like(j, ctx_len),
                        torch.full_like(j, ctx_start)], 1)
    return rows[:, None, :].expand(P, B, 4).contiguous().to(device)


def paged_decode_page(
    params: dict,
    tokens_page: torch.Tensor,  # (B, P) one full page of token ids
    meta,                       # (pos0, ctx_start)
    k_ctx: torch.Tensor,        # (L, B, KV, C, Hd) paged context; C may be 0
    v_ctx: torch.Tensor,
    tail_k: torch.Tensor,       # (L, B, KV, P, Hd) tail, updated in place
    tail_v: torch.Tensor,
    cfg: LlamaConfig,
    graphs: StepGraphs | None = None,
    ctx_len: int | None = None,
):
    """One full page of teacher-forced paged decode from an empty tail
    (``paged_decode_page_jit``, kv_paging.py:435): token j decodes at
    position pos0 + j with tail_len j, over the first ``ctx_len`` context
    keys (by default all C; less when the context is bucketed,
    :func:`bucket_context`). The JAX package scans the page in one
    program; here the P token steps run eagerly, or replay one captured
    token step P times through the caller's graph cache ``graphs``.
    Returns (logits (B, P, vocab), tail_k, tail_v)."""
    B, P = tokens_page.shape
    C = k_ctx.shape[3] if ctx_len is None else ctx_len
    metas = _page_metas(meta, B, P, C, tokens_page.device)
    out = []
    ctx_tag = object()  # the context is loaded into a graph once a page
    for j in range(P):
        args = (tokens_page[:, j], metas[j], k_ctx, v_ctx, tail_k, tail_v)
        if graphs is None:
            logits, _, _ = paged_token_step(params, *args, cfg)
        else:
            logits, _, _ = graphs.run(paged_token_step, args,
                                      {2: ctx_tag, 3: ctx_tag})
        out.append(logits.clone() if graphs is not None else logits)
    return torch.stack(out, 1), tail_k, tail_v


def paged_generate_page(
    params: dict,
    token0: torch.Tensor,   # (B,) the token that seeds this page
    meta,                   # (pos0, ctx_start)
    k_ctx: torch.Tensor,
    v_ctx: torch.Tensor,
    tail_k: torch.Tensor,   # (L, B, KV, P, Hd) empty tail, updated in place
    tail_v: torch.Tensor,
    cfg: LlamaConfig,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
):
    """One page of autoregressive paged decode (``paged_generate_page_jit``,
    kv_paging.py:486): each step consumes the previous step's sample
    (:func:`llama.sample_token`: greedy at ``temperature`` 0, else a
    softmax draw from ``generator``). Returns (sampled ids (B, P), tail_k,
    tail_v); the tail holds the K/V of every consumed token (token0 and the
    first P - 1 samples); the last sample seeds the next page."""
    B, P = token0.shape[0], tail_k.shape[3]
    metas = _page_metas(meta, B, P, k_ctx.shape[3], token0.device)
    tok, out = token0, []
    for j in range(P):
        logits, _, _ = paged_token_step(params, tok, metas[j], k_ctx, v_ctx,
                                        tail_k, tail_v, cfg)
        tok = llama.sample_token(logits, temperature, generator)
        out.append(tok)
    return torch.stack(out, 1), tail_k, tail_v


class BucketedPagedDecoder:
    """Decode session with OCM-paged KV history (the JAX class of the same
    name): a fixed (L, B, KV, page_tokens, Hd) tail, shipped as a page every
    ``page_tokens`` steps.

    ``refetch=True`` re-reads the whole paged context through one-sided
    gets at every page boundary instead of extending a local copy:
    O(pages^2) read traffic, the mode that exercises the get path.
    On the card :meth:`step_page` replays one captured token step per
    token (the JAX package's one compiled program per page), through
    ``graphs``, a :class:`~.graphs.StepGraphs` of the same params that
    decoders may share, by default the decoder's own, freed at
    :meth:`close`; on the CPU it runs eagerly."""

    def __init__(
        self,
        params: dict,
        cfg: LlamaConfig,
        backend,
        batch: int = 1,
        page_tokens: int = 16,
        kind: OcmKind = OcmKind.REMOTE_DEVICE,
        dtype: str = "float32",
        refetch: bool = False,
        graphs: StepGraphs | None = None,
    ):
        self.params = params
        self.cfg = cfg
        self.cache = PagedKVCache(backend, cfg, batch, page_tokens, kind, dtype)
        self.page_tokens = page_tokens
        self.refetch = refetch
        dev = params["embed"].device
        self._own_graphs = graphs is None and dev.type == "cuda"
        self.graphs = StepGraphs(params, cfg) if self._own_graphs else graphs
        self.pos = 0
        self._ctx_start = 0  # global position of the first retained page
        dt = torch_dtype(cfg.dtype)
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, page_tokens, cfg.head_dim)
        self._tail_k = torch.zeros(shape, dtype=dt, device=dev)
        self._tail_v = torch.zeros(shape, dtype=dt, device=dev)
        self._tail_len = 0
        empty = shape[:3] + (0,) + shape[4:]
        self._fetched = (torch.zeros(empty, dtype=dt, device=dev),
                         torch.zeros(empty, dtype=dt, device=dev))

    def step(self, token: torch.Tensor) -> torch.Tensor:
        logits, _, _ = paged_decode_step(
            self.params, token, self.pos, self._tail_len, self._ctx_start,
            self._fetched[0], self._fetched[1], self._tail_k, self._tail_v,
            self.cfg,
        )
        self.pos += 1
        self._tail_len += 1
        if self._tail_len == self.page_tokens:
            self._ship_page()
        return logits

    def _check_page_aligned(self, what: str) -> None:
        if self._tail_len != 0:
            raise ValueError(
                f"{what} needs an empty tail (tail_len={self._tail_len}); "
                "align step()/step_page() calls to page boundaries")

    def step_page(self, tokens_page: torch.Tensor) -> torch.Tensor:
        """Decode one full page of teacher-forced tokens
        (:func:`paged_decode_page`), then ship it. Needs an empty tail and
        exactly ``page_tokens`` ids a row. Returns logits (B, P, vocab)."""
        self._check_page_aligned("step_page")
        if tokens_page.shape[-1] != self.page_tokens:
            raise ValueError(f"step_page wants exactly page_tokens="
                             f"{self.page_tokens} ids, got "
                             f"{tokens_page.shape[-1]}")
        k_ctx, v_ctx = bucket_context(*self._fetched, self.page_tokens)
        logits, _, _ = paged_decode_page(
            self.params, tokens_page, (self.pos, self._ctx_start), k_ctx,
            v_ctx, self._tail_k, self._tail_v, self.cfg, graphs=self.graphs,
            ctx_len=self._fetched[0].shape[3])
        self.pos += self.page_tokens
        self._tail_len = self.page_tokens
        self._ship_page()
        return logits

    def generate_page(self, token: torch.Tensor, *,
                      generator: torch.Generator | None = None,
                      temperature: float = 0.0) -> torch.Tensor:
        """Sample one full page autoregressively from the (B,) seed
        ``token`` (:func:`paged_generate_page`), then ship it. Returns the
        (B, page_tokens) ids; the last seeds the next call."""
        self._check_page_aligned("generate_page")
        out, _, _ = paged_generate_page(
            self.params, token, (self.pos, self._ctx_start),
            self._fetched[0], self._fetched[1], self._tail_k, self._tail_v,
            self.cfg, generator=generator, temperature=temperature)
        self.pos += self.page_tokens
        self._tail_len = self.page_tokens
        self._ship_page()
        return out

    def _ship_page(self) -> None:
        """Page boundary: ship the full tail, evict pages that left the
        sliding window, then refetch the paged context or extend the local
        copy."""
        cdt = torch_dtype(self.cache.dtype)
        k_page, v_page = self._tail_k.to(cdt), self._tail_v.to(cdt)
        self.cache.store_page(k_page, v_page)
        dt = torch_dtype(self.cfg.dtype)
        if self.cfg.window is not None:
            while (self.cache.pages and self._ctx_start
                   + self.page_tokens <= self.pos - self.cfg.window):
                self.cache.drop_oldest()
                self._ctx_start += self.page_tokens
                if not self.refetch:
                    self._fetched = tuple(
                        f[:, :, :, self.page_tokens:] for f in self._fetched
                    )
        if self.refetch:
            fk, fv = self.cache.fetch_pages()
            self._fetched = (fk.to(dt), fv.to(dt))
        else:
            self._fetched = (
                torch.cat([self._fetched[0], k_page.to(dt)], dim=3),
                torch.cat([self._fetched[1], v_page.to(dt)], dim=3),
            )
        # Stale tail slots lie past tail_len and are never read.
        self._tail_len = 0

    def close(self) -> None:
        self.cache.free()
        if self._own_graphs:
            self.graphs.close()


class PagedDecoder:
    """A decode session whose KV history pages out through OCM (the JAX
    class of the same name): one page of tail KV locally; every
    ``page_tokens`` steps the tail ships as a page and decode goes on
    against the pages held locally plus a fresh tail. A session resumed
    over pages stored before fetches them once. No eviction: with a
    sliding window, attention reads the keys inside it."""

    def __init__(
        self,
        params: dict,
        cfg: LlamaConfig,
        backend,
        batch: int = 1,
        page_tokens: int = 16,
        kind: OcmKind = OcmKind.REMOTE_DEVICE,
        dtype: str = "float32",
    ):
        self.params = params
        self.cfg = cfg
        self.cache = PagedKVCache(backend, cfg, batch, page_tokens, kind, dtype)
        self.page_tokens = page_tokens
        self.pos = 0
        dev = params["embed"].device
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, page_tokens, cfg.head_dim)
        dt = torch_dtype(cfg.dtype)
        self._tail_k = torch.zeros(shape, dtype=dt, device=dev)
        self._tail_v = torch.zeros(shape, dtype=dt, device=dev)
        self._tail_len = 0
        self._fetched = None  # the paged context (k, v), once there is one

    def _context(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.cache.pages and self._fetched is None:
            self._fetched = self.cache.fetch_pages()  # resuming: one fetch
        if self._fetched is not None:
            return self._fetched
        empty = self._tail_k[:, :, :, :0]
        return empty, empty

    def step(self, token: torch.Tensor) -> torch.Tensor:
        k_ctx, v_ctx = self._context()
        logits, _, _ = paged_decode_step(
            self.params, token, self.pos, self._tail_len, 0, k_ctx, v_ctx,
            self._tail_k, self._tail_v, self.cfg)
        self.pos += 1
        self._tail_len += 1
        if self._tail_len == self.page_tokens:
            cdt = torch_dtype(self.cache.dtype)
            k_page, v_page = self._tail_k.to(cdt), self._tail_v.to(cdt)
            self.cache.store_page(k_page, v_page)
            if self._fetched is None:
                self._fetched = (k_page.clone(), v_page.clone())
            else:  # pages held locally: traffic O(pages), not O(pages^2)
                self._fetched = (torch.cat([self._fetched[0], k_page], 3),
                                 torch.cat([self._fetched[1], v_page], 3))
            self._tail_len = 0
        return logits

    def close(self) -> None:
        self.cache.free()
