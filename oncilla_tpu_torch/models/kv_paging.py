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
into the tail buffer in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.hbm import from_bytes, to_bytes
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.models import llama
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
    kind: OcmKind = OcmKind.LOCAL_DEVICE
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
        host kinds; None for device kinds (their gets stay on the card)."""
        if self.kind != OcmKind.LOCAL_HOST:
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


class BucketedPagedDecoder:
    """Decode session with OCM-paged KV history (the JAX class of the same
    name): a fixed (L, B, KV, page_tokens, Hd) tail, shipped as a page every
    ``page_tokens`` steps.

    ``refetch=True`` re-reads the whole paged context through one-sided
    gets at every page boundary instead of extending a local copy:
    O(pages^2) read traffic, the mode that exercises the get path."""

    def __init__(
        self,
        params: dict,
        cfg: LlamaConfig,
        backend,
        batch: int = 1,
        page_tokens: int = 16,
        kind: OcmKind = OcmKind.LOCAL_DEVICE,
        dtype: str = "float32",
        refetch: bool = False,
    ):
        self.params = params
        self.cfg = cfg
        self.cache = PagedKVCache(backend, cfg, batch, page_tokens, kind, dtype)
        self.page_tokens = page_tokens
        self.refetch = refetch
        self.pos = 0
        self._ctx_start = 0  # global position of the first retained page
        dev = params["embed"].device
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
