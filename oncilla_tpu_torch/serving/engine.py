"""Continuous-batching decode engine over the tiered KV page store, the
port's copy of ``oncilla_tpu/serving/engine.py``.

Sessions (one per tenant request) decode page by page; admissions join
between turns (continuous batching); every session's KV context lives as
pages in the :class:`~.tiers.TieredPageStore`, shared across tenants
through the :class:`~.prefix.PrefixCache`.

- **Prefill with prefix reuse.** A session adopts shared extents covering
  its prompt instead of recomputing them (probed at every page boundary,
  so sessions admitted together still dedup), computes the rest, and
  publishes every completed prompt-only page. A matched partial tail is
  adopted by copy-on-write.
- **Prefetch on schedule.** Off-card pages of the next session are
  fetched by worker threads (or AsyncOcm coroutines) into pinned host
  buffers; waiting on one is recorded as stall (``prefetch_stall``
  journal events, stall counters).
- **Batched decode** (default; ``OCM_SERVING_BATCH=0`` interleaves
  sessions one token step each): every seated session advances one token
  per tick in one :func:`~..models.kv_paging.paged_decode_batch_step` over
  a pool of resident pages and a block table, B, pages and pool rows
  bucketed to powers of two. Long prompts prefill a page a tick (chunked
  prefill); higher priorities seat first; a step budget
  (``OCM_STEP_BUDGET_MS``) bounds the wait on a straggling prefetch.
- **On the card.** Page bytes stay on the device where the tier is: a HOT
  page reaches the pool by the ``read_rows`` kernel into a device tensor,
  an off-card page by one non-blocking copy from a pinned buffer, and a
  promotion or a shipped page lands by ``write_rows``. Each step function
  runs through one CUDA graph per input shapes
  (:class:`~..models.graphs.StepGraphs`), the counterpart of the JAX
  package's one jit program per shape bucket; a session's context is
  bucketed to a power of two of pages (:func:`~..models.kv_paging.
  bucket_context`), as the batched step's pages and pool rows are, so the
  graphs a model keeps stay O(log) in the context's length. On the CPU
  the steps run eagerly.
- **Determinism.** Greedy decode: the emitted tokens are a function of
  (params, prompt), whatever tier a page lives in.

Knobs, as in the JAX package: ``OCM_SERVE_PREFETCH`` (workers),
``OCM_STEP_BUDGET_MS``, ``OCM_SERVING_BATCH``, ``OCM_SERVING_MAX_BATCH``.
A COLD tier on a remote host is read by the prefetch workers over the
wire, from their own threads (the daemon client is thread-safe), or, when
the cold client is a mux client, by AsyncOcm coroutines on its event loop.
Not ported: the FROZEN tier's warm boot (ROADMAP A 2.5).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
from dataclasses import dataclass

import torch

from oncilla_tpu_torch.core.hbm import from_bytes, to_bytes
from oncilla_tpu_torch.models.graphs import StepGraphs
from oncilla_tpu_torch.models.kv_paging import (
    bucket_context,
    paged_decode_batch_step,
    paged_decode_page,
    paged_token_step,
)
from oncilla_tpu_torch.models.llama import torch_dtype
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.qos.policy import PRIO_NORMAL
from oncilla_tpu_torch.resilience import timebudget
from oncilla_tpu_torch.serving import metrics as serving_metrics
from oncilla_tpu_torch.serving.metrics import ServingStats
from oncilla_tpu_torch.serving.prefix import PrefixCache, SharedExtent
from oncilla_tpu_torch.serving.tiers import Page, Tier, TieredPageStore
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER, printd


def _pow2(n: int) -> int:
    """Smallest power of two >= n (the shape buckets)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclass
class Request:
    """One tenant's generation request (greedy decode). ``priority`` is a
    QoS class: the batched scheduler admits and seats higher ones first."""

    tenant: str
    tokens: list[int]
    max_new_tokens: int = 16
    priority: int = PRIO_NORMAL


@dataclass
class SessionResult:
    tenant: str
    prompt_len: int
    out_tokens: list[int]
    stall_s: float
    prefix_tokens_reused: int


class Prefetcher:
    """Fetch off-card page bytes ahead of schedule into reusable pinned
    host buffers. ``workers == 0`` disables prefetch entirely (every miss
    is a synchronous fault). With a mux-backed cold client (``OCM_MUX=1``)
    COLD fetches ride :class:`~oncilla_tpu_torch.runtime.mux.AsyncOcm`
    coroutines on the shared event loop (zero extra threads, tagged
    pipelining on the one connection per peer), as in the JAX package;
    otherwise a pool of worker threads reads through
    :meth:`TieredPageStore.fetch_bytes`. Either way a fetch touches host
    memory only: the coroutine lands the page in a numpy view of a pinned
    buffer, and no kernel launch leaves the engine thread. A buffer goes
    back to the pool with an event recorded after its upload, and is not
    handed out again before that event."""

    def __init__(self, store: TieredPageStore, workers: int = 2,
                 stats: ServingStats | None = None):
        self.store = store
        self.stats = stats or store.stats
        self.workers = workers
        self._pool = None
        self._aocm = None
        self._mux_rt = None
        self._bufs: list[tuple] = []   # (pinned buffer, event or None)
        self._futures: dict[int, cf.Future] = {}
        if workers <= 0:
            return
        client = store.cold_backend
        rt = getattr(client, "_mux", None) if client is not None else None
        if rt is not None:
            try:
                self._open_async(client, rt)
            except Exception as e:  # noqa: BLE001 — degrade to threads
                printd("serving: AsyncOcm prefetch unavailable (%s); "
                       "using threads", e)
        if self._aocm is None:
            self._pool = cf.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ocm-prefetch")

    def _open_async(self, client, rt) -> None:
        from oncilla_tpu_torch.runtime.mux import AsyncOcm

        self._aocm = rt.run(AsyncOcm.open(
            client.entries, client.rank, config=client.config,
            channels=rt.channels, heartbeat=False,
        ))
        self._mux_rt = rt

    @property
    def mode(self) -> str:
        if self._aocm is not None:
            return "async"
        return "thread" if self._pool is not None else "off"

    def take_buf(self) -> torch.Tensor:
        """A page-sized host buffer whose last upload has completed."""
        if self._bufs:
            buf, evt = self._bufs.pop()
            if evt is not None:
                evt.synchronize()
            return buf
        return torch.empty(self.store.page_bytes, dtype=torch.uint8,
                           pin_memory=self.store.device.type == "cuda")

    def submit(self, page: Page) -> None:
        """Schedule a fetch of ``page`` (idempotent per page)."""
        if self.mode == "off" or page.page_id in self._futures:
            return
        if self.mode == "async" and page.tier != Tier.COLD:
            return  # warm reads are local copies; not worth a coroutine
        buf = self.take_buf()
        version = page.version
        self.stats.note_prefetch()
        if self._aocm is not None:
            nbytes = page.nbytes
            # The loop thread writes host bytes only: a numpy view of the
            # pinned buffer, taken here on the engine thread.
            dest = buf.numpy()[:nbytes]

            async def go():
                await self._aocm.get(page.handle, nbytes, 0, out=dest)
                self.stats.note_remote(nbytes, inbound=True)
                return (buf, version, True)

            self._futures[page.page_id] = self._mux_rt.submit(go())
        else:
            def fetch():
                ver, ok = self.store.fetch_bytes(page, buf)
                return (buf, ver, ok)

            self._futures[page.page_id] = self._pool.submit(fetch)

    def take(self, page_id: int):
        """The pending future for ``page_id`` (consumed), or None."""
        return self._futures.pop(page_id, None)

    def pending(self, page_id: int) -> bool:
        """True while a submitted fetch for ``page_id`` has not landed."""
        fut = self._futures.get(page_id)
        return fut is not None and not fut.done()

    def recycle(self, buf: torch.Tensor) -> None:
        if len(self._bufs) < max(self.workers, 2):
            evt = None
            if buf.is_pinned():
                evt = torch.cuda.Event()
                evt.record()  # after the upload enqueued from this buffer
            self._bufs.append((buf, evt))

    def close(self) -> None:
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if self._aocm is not None:
            try:
                self._mux_rt.run(self._aocm.aclose(detach=True))
            except Exception as e:  # noqa: BLE001 — the runtime may
                # already be shut down by the owning client's close
                printd("serving: AsyncOcm close failed: %s", e)
            self._aocm = None


@dataclass
class _Entry:
    """One page of a session's context."""

    page: Page
    extent: SharedExtent | None = None
    #: True while this page's KV is still being produced in the tail (a
    #: CoW-adopted partial): storage only, not attention context.
    pending_fill: bool = False
    arrays: tuple | None = None   # (k, v) on the device, cfg dtype
    version: int = -1             # page.version the arrays were built at


class _Session:
    def __init__(self, req: Request, cfg, page_tokens: int, device):
        self.req = req
        self.prompt = [int(t) for t in req.tokens]
        self.entries: list[_Entry] = []
        self.shared_refs: list[SharedExtent] = []
        self.out: list[int] = []
        self.pos = 0
        self.prompt_consumed = 0
        self.tail_len = 0
        self.page_toks: list[int] = []  # token ids whose KV fills the tail
        self.chain_parent: SharedExtent | None = None
        self.chain_valid = True
        self.prefix_tokens_reused = 0
        self.stall_s = 0.0
        self.done = False
        self.priority = int(getattr(req, "priority", PRIO_NORMAL))
        self.submit_t = float(getattr(req, "_submit_t", 0.0) or 0.0)
        self.ttft_noted = False
        self._tail_shape = (cfg.n_layers, 1, cfg.n_kv_heads, page_tokens,
                            cfg.head_dim)
        self._tail_dt = torch_dtype(cfg.dtype)
        self._device = device
        self.reset_tail()

    def reset_tail(self) -> None:
        # Fresh zeros every page: a published partial page is the same
        # bytes beyond its fill whoever produced it, and the page just
        # shipped keeps the old tensors as its decode arrays.
        self.tail_k = torch.zeros(self._tail_shape, dtype=self._tail_dt,
                                  device=self._device)
        self.tail_v = torch.zeros_like(self.tail_k)
        self.tail_len = 0
        self.page_toks = []


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that no later step writes into."""
    return t.clone(memory_format=torch.contiguous_format)


class ServingEngine:
    """Continuous batching over one page store (batched, or interleaved
    batch-of-1 turns)."""

    def __init__(
        self,
        params: dict,
        cfg,
        store: TieredPageStore,
        prefix: PrefixCache | None = None,
        page_tokens: int = 16,
        max_active: int = 4,
        prefetch_workers: int | None = None,
        store_dtype: str = "float32",
        name: str = "engine",
        share_partials: bool = True,
        step_budget_ms: int | None = None,
        batched: bool | None = None,
        max_batch: int | None = None,
    ):
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        if store.device != self.device:
            raise ValueError(f"store on {store.device}, params on {self.device}")
        self.store = store
        self.prefix = prefix
        self.page_tokens = int(page_tokens)
        self.max_active = int(max_active)
        self.store_dtype = store_dtype
        self.share_partials = share_partials
        self.stats = store.stats
        self.stats.engine = name
        if prefetch_workers is None:
            prefetch_workers = int(os.environ.get("OCM_SERVE_PREFETCH", "2"))
        self.prefetcher = Prefetcher(store, prefetch_workers, self.stats)
        # Per-step budget: bounds how long a step waits on a straggling
        # prefetch before faulting the page synchronously. 0 = unbudgeted.
        if step_budget_ms is None:
            step_budget_ms = int(os.environ.get("OCM_STEP_BUDGET_MS", "0") or 0)
        self.step_budget_ms = max(0, int(step_budget_ms))
        self._step_budget = None
        if batched is None:
            batched = os.environ.get("OCM_SERVING_BATCH", "1") != "0"
        self.batched = bool(batched)
        if max_batch is None:
            max_batch = int(os.environ.get("OCM_SERVING_MAX_BATCH", "8"))
        self.max_batch = max(1, int(max_batch))
        #: The captured steps on the card, freed at :meth:`close`; None
        #: (the CPU) runs every step eagerly.
        self.graphs = (StepGraphs(params, cfg) if self.device.type == "cuda"
                       else None)
        # The tick's page pool, rebuilt only when the resident page set
        # changes: (key, pool_k, pool_v).
        self._pool_cache: tuple = (None, None, None)
        # Steady-state fast path: the last step's stacked tails feed the
        # next step while batch membership is unchanged.
        self._tail_stack: tuple | None = None
        self._tab_cache: tuple = (None, None)
        self.queue: list[Request] = []
        self.active: list[_Session] = []
        self.results: list[SessionResult] = []
        self.page_shape = (2, cfg.n_layers, 1, cfg.n_kv_heads,
                           self.page_tokens, cfg.head_dim)
        expect = self.page_nbytes(cfg, self.page_tokens, store_dtype)
        if expect != store.page_bytes:
            raise ValueError(
                f"store page_bytes {store.page_bytes} != model page "
                f"{expect} (cfg/page_tokens/store_dtype mismatch)")
        serving_metrics.publish(self.stats)

    @staticmethod
    def page_nbytes(cfg, page_tokens: int, store_dtype: str = "float32") -> int:
        """Size of one packed (K+V) page for ``cfg``: what the
        :class:`TieredPageStore` must be built with."""
        return (2 * cfg.n_layers * cfg.n_kv_heads * page_tokens * cfg.head_dim
                * torch_dtype(store_dtype).itemsize)

    # -- submission / driving --------------------------------------------

    def submit(self, req: Request) -> None:
        # TTFT starts at submit: queue wait is latency a tenant sees.
        req._submit_t = time.perf_counter()
        self.queue.append(req)

    def _new_budget(self) -> None:
        if self.step_budget_ms:
            self._step_budget = timebudget.Budget.from_ms(self.step_budget_ms)

    def run(self, turn_tokens: int | None = None) -> list[SessionResult]:
        """Drive to completion and collect results: tick-based batched
        decode, or interleaved page-granular turns with prefetch on
        schedule."""
        if self.batched:
            return self._run_batched()
        turn = turn_tokens or self.page_tokens
        while self.queue or self.active:
            while self.queue and len(self.active) < self.max_active:
                self.active.append(self._admit(self.queue.pop(0)))
            order = list(self.active)
            for i, sess in enumerate(order):
                if sess.done:
                    continue
                # The next session's off-card pages fetch while this one
                # computes.
                for nxt in order[i + 1:]:
                    if not nxt.done:
                        self._prefetch_for(nxt)
                        break
                self._new_budget()
                self._turn(sess, turn)
                if sess.done:
                    self._finish(sess)
            self.active = [s for s in self.active if not s.done]
        done, self.results = self.results, []
        return done

    def close(self) -> None:
        for sess in self.active:
            self._finish(sess, abandon=True)
        self.active = []
        self.prefetcher.close()
        if self.graphs is not None:
            self.graphs.close()
        self._pool_cache = (None, None, None)
        self._tail_stack = None
        serving_metrics.unpublish(self.stats)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the step functions (eager, or through the graphs) ---------------

    def _run(self, fn, args, tags=None):
        if self.graphs is not None:
            return self.graphs.run(fn, args, tags)
        return fn(self.params, *args, self.cfg)

    def _decode_one(self, sess: _Session, args, tags):
        """One token of one session (interleaved turns)."""
        return self._run(paged_token_step, args, tags)

    def _decode_page(self, sess: _Session, args, ctx_len: int):
        """One page of one session's prompt (chunked prefill)."""
        return paged_decode_page(self.params, *args, self.cfg,
                                 graphs=self.graphs, ctx_len=ctx_len)

    def _decode_batch(self, batch: list[_Session], args, tags):
        """One token of every seated session."""
        return self._run(paged_decode_batch_step, args, tags)

    # -- admission / prefill ---------------------------------------------

    def _admit(self, req: Request) -> _Session:
        # Prefix matching is incremental (_match_more at every page
        # boundary), so sessions admitted together still dedup.
        return _Session(req, self.cfg, self.page_tokens, self.device)

    def _match_more(self, sess: _Session) -> None:
        """At a page boundary during prefill, adopt any shared extent
        covering the next chunk of the prompt. The last prompt token is
        always computed (its logits seed generation), so a whole-remainder
        match becomes a CoW adoption of all but one of its tokens."""
        if (self.prefix is None or not sess.chain_valid
                or sess.tail_len != 0):
            return
        P = self.page_tokens
        while True:
            pc = sess.prompt_consumed
            rem = len(sess.prompt) - pc
            if rem <= 1:
                return
            if rem > P:
                ext = self.prefix.child(sess.chain_parent,
                                        sess.prompt[pc:pc + P])
                if ext is None or ext.fill != P:
                    return
                self.prefix.acquire(ext)
                sess.shared_refs.append(ext)
                sess.entries.append(_Entry(page=ext.page, extent=ext))
                sess.chain_parent = ext
                sess.pos += P
                sess.prompt_consumed += P
                sess.prefix_tokens_reused += P
                self.stats.note_tokens(P, phase="prefill")
                continue
            # 2 <= rem <= P: the prompt's tail chunk.
            ext = self.prefix.child(sess.chain_parent, sess.prompt[pc:])
            if ext is not None and ext.fill > 1:
                self._adopt_partial(sess, ext, upto=rem - 1)
                sess.prompt_consumed += rem - 1
                self.stats.note_tokens(rem - 1, phase="prefill")
            return

    def _adopt_partial(self, sess: _Session, ext: SharedExtent,
                       upto: int) -> None:
        """Copy-on-write adoption of a shared tail: the session goes on in
        a private clone, loading the first ``upto`` tokens' KV from it."""
        self.prefix.acquire(ext)
        sess.shared_refs.append(ext)
        clone = self.store.cow(ext.page)
        sess.tail_k, sess.tail_v = (_own(a) for a in
                                    self._unpack(self.store.read_page(clone)))
        sess.tail_len = upto
        sess.page_toks = list(ext.tokens[:upto])
        sess.pos += upto
        sess.prefix_tokens_reused += upto
        sess.entries.append(_Entry(page=clone, pending_fill=True))
        # The completed clone extends the node above the partial.
        sess.chain_parent = ext.parent

    # -- residency / prefetch --------------------------------------------

    def _unpack(self, raw: torch.Tensor) -> tuple:
        """Page bytes as decode arrays (k, v) on the device (views of
        ``raw`` when it is already there in the model's dtype)."""
        raw = raw.to(self.device)  # off-card bytes: one blocking copy
        packed = from_bytes(raw, self.page_shape, torch_dtype(self.store_dtype))
        dt = torch_dtype(self.cfg.dtype)
        return packed[0].to(dt), packed[1].to(dt)

    def _upload(self, buf: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer's bytes in a fresh device tensor, by one
        non-blocking copy; the buffer is recycled behind an event."""
        if self.device.type == "cuda":
            dev = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
            dev.copy_(buf, non_blocking=True)
        else:
            dev = buf.clone()
        self.prefetcher.recycle(buf)
        return dev

    def _resident(self, e: _Entry) -> bool:
        return (e.arrays is not None and e.version == e.page.version
                and e.page.tier == Tier.HOT)

    def _prefetch_for(self, sess: _Session) -> None:
        for e in sess.entries:
            if (not e.pending_fill and not self._resident(e)
                    and e.page.tier != Tier.HOT):
                self.prefetcher.submit(e.page)

    def _ensure_resident(self, sess: _Session) -> None:
        self._ensure_resident_batch([sess], sweep_once=False)

    def _ensure_resident_batch(self, batch: list[_Session],
                               sweep_once: bool = True) -> None:
        """Every context page of ``batch`` resident with current arrays. A
        hit is a page on the card at schedule time (rebuilt from it if its
        arrays went stale); a miss is obtained (prefetch or fault),
        uploaded once and promoted. With ``sweep_once`` the promotions of
        one tick install under ONE watermark sweep
        (:meth:`TieredPageStore.promote_many`), so B sessions' faults
        cannot thrash each other's fresh pages; else one sweep a page, as
        the interleaved engine does."""
        items, installs = [], []
        seen: dict[int, tuple] = {}
        for sess in batch:
            for e in sess.entries:
                if e.pending_fill:
                    continue
                hot = e.page.tier == Tier.HOT
                self.stats.note_lookup(hot)
                if self._resident(e):
                    self.store.touch(e.page)
                    continue
                if hot:
                    e.arrays = self._unpack(self.store.read_page(e.page))
                    e.version = e.page.version
                    continue
                pid = e.page.page_id
                if pid not in seen:
                    got = seen[pid] = self._obtain(sess, e.page)
                    if sweep_once:
                        items.append((e.page, got[0], got[1]))
                    else:
                        self.store.promote(e.page, data=got[0], version=got[1])
                installs.append((e, seen[pid]))
        if items:
            self.store.promote_many(items)
        for e, (data, _version) in installs:
            e.arrays = self._unpack(data)  # the bytes of the page's version
            e.version = e.page.version

    def _recycle_late(self, fut) -> None:
        """A prefetch abandoned past the step budget lands later: its
        buffer goes back to the pool."""
        if not fut.cancelled() and fut.exception() is None:
            self.prefetcher.recycle(fut.result()[0])

    def _obtain(self, sess: _Session, page: Page):
        """Page bytes on the device + the version they are of: a completed
        prefetch is free; waiting on one (or faulting with none issued) is
        stall time."""
        fut = self.prefetcher.take(page.page_id)
        if fut is not None:
            already = fut.done()
            t0 = time.perf_counter()
            wait_s = 120.0
            if self._step_budget is not None:
                wait_s = min(wait_s, max(self._step_budget.remaining_s(), 1e-3))
            try:
                buf, version, ok = fut.result(timeout=wait_s)
            except cf.TimeoutError:
                waited = time.perf_counter() - t0
                sess.stall_s += waited
                self.stats.note_stall(waited)
                obs_journal.record("prefetch_stall", page_id=page.page_id,
                                   wait_ms=round(waited * 1e3, 3),
                                   degraded=True)
                fut.add_done_callback(self._recycle_late)
                buf, version, ok = None, -1, False
            waited = time.perf_counter() - t0
            if ok and version == page.version:
                self.stats.note_prefetch(completed=True)
                if not already:
                    # The prefetch lost the race: the decode sat waiting.
                    sess.stall_s += waited
                    self.stats.note_stall(waited)
                    obs_journal.record("prefetch_stall", page_id=page.page_id,
                                       wait_ms=round(waited * 1e3, 3))
                return (self._upload(buf), version)
            if buf is not None:
                self.prefetcher.recycle(buf)
        # Page fault: no usable prefetch, the whole fetch is stall.
        t0 = time.perf_counter()
        version = page.version
        buf = self.prefetcher.take_buf()
        self.store.read_page(page, out=buf)
        data = self._upload(buf)
        stall = time.perf_counter() - t0
        sess.stall_s += stall
        self.stats.note_stall(stall)
        obs_journal.record("prefetch_stall", page_id=page.page_id,
                           wait_ms=round(stall * 1e3, 3), fault=True)
        return (data, version)

    def _context(self, sess: _Session) -> tuple:
        """(k_ctx, v_ctx, ctx_len): the session's context pages in order,
        bucketed (:func:`bucket_context`), and the keys that are real."""
        ks = [e.arrays[0] for e in sess.entries if not e.pending_fill]
        vs = [e.arrays[1] for e in sess.entries if not e.pending_fill]
        if not ks:
            empty = sess.tail_k[:, :, :, :0]
            return empty, empty, 0
        k, v = bucket_context(torch.cat(ks, 3), torch.cat(vs, 3),
                              self.page_tokens)
        return k, v, len(ks) * self.page_tokens

    def _ids(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.long).to(self.device)

    # -- decode -----------------------------------------------------------

    def _next_token(self, sess: _Session) -> tuple[int, bool]:
        """The token this session consumes next, and whether it is a
        prompt token."""
        if sess.prompt_consumed < len(sess.prompt):
            tok = sess.prompt[sess.prompt_consumed]
            sess.prompt_consumed += 1
            self.stats.note_tokens(1, phase="prefill")
            return tok, True
        return (sess.out[-1] if sess.out else sess.prompt[-1]), False

    def _turn(self, sess: _Session, budget: int) -> None:
        self._match_more(sess)
        self._ensure_resident(sess)
        k_ctx, v_ctx, ctx_len = self._context(sess)
        ctx_tag = object()  # a graph loads the context once a page
        for _ in range(budget):
            tok, prefill = self._next_token(sess)
            meta = self._ids([[sess.pos, sess.tail_len, ctx_len, 0]])
            logits, _, _ = self._decode_one(
                sess, (self._ids([tok]), meta, k_ctx, v_ctx, sess.tail_k,
                       sess.tail_v), {2: ctx_tag, 3: ctx_tag})
            sess.pos += 1
            sess.tail_len += 1
            sess.page_toks.append(int(tok))
            if not prefill or sess.prompt_consumed == len(sess.prompt):
                sess.out.append(int(torch.argmax(logits[0])))
                self._note_first_token(sess)
                if not prefill:
                    self.stats.note_tokens(1)
            if sess.tail_len == self.page_tokens:
                self._ship(sess)
                # A sibling may have published the next chunk meanwhile.
                self._match_more(sess)
                self._ensure_resident(sess)
                k_ctx, v_ctx, ctx_len = self._context(sess)
                ctx_tag = object()
            elif (self.share_partials and prefill
                  and sess.prompt_consumed == len(sess.prompt)):
                self._publish_partial(sess)
            if len(sess.out) > sess.req.max_new_tokens:
                raise AssertionError("overran max_new_tokens")
            if len(sess.out) == sess.req.max_new_tokens:
                sess.done = True
                return

    # -- batched decode ----------------------------------------------------

    def _run_batched(self) -> list[SessionResult]:
        """Per tick: priority-ordered admission, one chunked-prefill page
        per bulk-prefilling session, then one batched step advancing every
        seated session by one token."""
        while self.queue or self.active:
            self._tick()
        done, self.results = self.results, []
        return done

    def _tick(self) -> None:
        if self.queue and len(self.active) < self.max_active:
            # Stable within a class: equal priorities keep arrival order.
            self.queue.sort(key=lambda r: -getattr(r, "priority", PRIO_NORMAL))
            while self.queue and len(self.active) < self.max_active:
                self.active.append(self._admit(self.queue.pop(0)))
        self._new_budget()
        prefetch_on = self.prefetcher.mode != "off"
        for sess in self.active:
            self._match_more(sess)
            if prefetch_on:
                self._prefetch_for(sess)
        chunked = False
        for sess in self.active:
            if not self._bulk_prefill(sess):
                continue
            # A session earlier in this tick may have published exactly
            # the page this one is about to compute.
            self._match_more(sess)
            if self._bulk_prefill(sess):
                with GLOBAL_TRACER.span("serve_prefill_chunk"):
                    self._prefill_chunk(sess)
                chunked = True
        batch = self._select_batch(allow_force=not chunked)
        if batch:
            with GLOBAL_TRACER.span("serve_batch_step"):
                self._batch_step(batch)
        for sess in self.active:
            if sess.done:
                self._finish(sess)
        self.active = [s for s in self.active if not s.done]

    def _note_first_token(self, sess: _Session) -> None:
        """TTFT, once a session, on its first emitted token."""
        if len(sess.out) == 1 and sess.submit_t and not sess.ttft_noted:
            sess.ttft_noted = True
            self.stats.note_ttft(time.perf_counter() - sess.submit_t)

    def _bulk_prefill(self, sess: _Session) -> bool:
        """True while at least one whole page of prompt remains and the
        tail is page-aligned: the state chunked prefill consumes."""
        return (not sess.done and sess.tail_len == 0
                and len(sess.prompt) - sess.prompt_consumed >= self.page_tokens)

    def _prefill_chunk(self, sess: _Session) -> None:
        """Teacher-force one full page of prompt, ship it, and emit the
        seed token when the prompt completes."""
        P = self.page_tokens
        r0 = time.perf_counter()
        self._ensure_resident(sess)
        k_ctx, v_ctx, ctx_len = self._context(sess)
        obs_journal.phase("residency", time.perf_counter() - r0,
                          priority=sess.priority)
        pc = sess.prompt_consumed
        chunk = sess.prompt[pc:pc + P]
        j0 = time.perf_counter()
        logits, _, _ = self._decode_page(
            sess, (self._ids([chunk]), (sess.pos, 0), k_ctx, v_ctx,
                   sess.tail_k, sess.tail_v), ctx_len)
        obs_journal.phase("step", time.perf_counter() - j0,
                          priority=sess.priority)
        sess.pos += P
        sess.tail_len = P
        sess.page_toks = list(chunk)
        sess.prompt_consumed += P
        self.stats.note_tokens(P, phase="prefill")
        self.stats.note_prefill_chunk()
        obs_journal.record("prefill_chunk", tenant=sess.req.tenant,
                           tokens=P, pos=sess.pos)
        if sess.prompt_consumed == len(sess.prompt):
            sess.out.append(int(torch.argmax(logits[0, -1])))
            self._note_first_token(sess)
            if len(sess.out) == sess.req.max_new_tokens:
                sess.done = True
        self._ship(sess)
        self._match_more(sess)

    def _yields_cold(self, sess: _Session) -> bool:
        """True when a seat should be given up this tick: a context page
        is off the card with its prefetch still in flight."""
        if self.prefetcher.mode == "off":
            return False
        return any(not e.pending_fill and not self._resident(e)
                   and e.page.tier != Tier.HOT
                   and self.prefetcher.pending(e.page.page_id)
                   for e in sess.entries)

    def _select_batch(self, allow_force: bool) -> list[_Session]:
        """Seating for one step: cold sessions yield, the rest seat in
        priority order up to ``max_batch``; losers count as preempts. With
        ``allow_force`` the best yielded session seats when nothing else
        ran this tick (progress), taking its fault synchronously."""
        runnable = [s for s in self.active
                    if not s.done and not self._bulk_prefill(s)]
        ready, yielded = [], []
        for sess in runnable:
            if self._yields_cold(sess):
                yielded.append(sess)
                self.stats.note_preempt("cold_page")
            else:
                ready.append(sess)
        if not ready and yielded and allow_force:
            yielded.sort(key=lambda s: -s.priority)
            ready = [yielded[0]]
        ready.sort(key=lambda s: -s.priority)
        for _ in ready[self.max_batch:]:
            self.stats.note_preempt("slot")
        return ready[:self.max_batch]

    def _batch_pool(self, batch: list[_Session]):
        """The tick's page pool and block table: every distinct resident
        page once, as a (N_pad, L, KV, P, Hd) pool; table[b] lists session
        b's rows. N and MP snap to powers of two; the pool is cached on the
        (page_id, version) set, so steady-state decode restacks nothing
        until a page boundary. Returns (pool_k, pool_v, table, tables,
        pool_key)."""
        index: dict[tuple, int] = {}
        rows, tables = [], []
        for sess in batch:
            trow = []
            for e in sess.entries:
                if e.pending_fill:
                    continue
                key = (e.page.page_id, e.version)
                if key not in index:
                    index[key] = len(rows)
                    rows.append(e.arrays)
                trow.append(index[key])
            tables.append(trow)
        max_pages = max((len(t) for t in tables), default=0)
        mp = _pow2(max_pages) if max_pages else 0
        n_pad = _pow2(len(rows)) if rows else 1
        cache_key = (tuple(index), n_pad)
        if self._pool_cache[0] == cache_key:
            pool_k, pool_v = self._pool_cache[1], self._pool_cache[2]
        else:
            cfg = self.cfg
            zrow = torch.zeros((cfg.n_layers, cfg.n_kv_heads, self.page_tokens,
                                cfg.head_dim), dtype=torch_dtype(cfg.dtype),
                               device=self.device)
            pad = n_pad - len(rows)
            pool_k = torch.stack([a[0][:, 0] for a in rows] + [zrow] * pad)
            pool_v = torch.stack([a[1][:, 0] for a in rows] + [zrow] * pad)
            self._pool_cache = (cache_key, pool_k, pool_v)
        table = [t + [0] * (mp - len(t)) for t in tables]
        return pool_k, pool_v, table, tables, cache_key

    def _batch_step(self, batch: list[_Session]) -> None:
        """One step advancing every seated session by one token, then the
        per-session bookkeeping."""
        t0 = time.perf_counter()
        self._ensure_resident_batch(batch)
        obs_journal.phase("residency", time.perf_counter() - t0,
                          priority=max(s.priority for s in batch))
        P = self.page_tokens
        pool_k, pool_v, table, tables, pool_key = self._batch_pool(batch)
        b_pad = _pow2(len(batch))
        toks, metas, prefills = [], [], []
        for sess, trow in zip(batch, tables):
            tok, prefill = self._next_token(sess)
            toks.append(tok)
            prefills.append(prefill)
            metas.append([sess.pos, sess.tail_len, len(trow) * P, 0])
        pad_b = b_pad - len(batch)
        toks += [0] * pad_b
        metas += [[0, 0, 0, 0]] * pad_b
        st = self._tail_stack
        if (st is not None and st[0] == batch
                and all(s.tail_k is None for s in batch)):
            # Same seated sessions and nobody shipped: the last step's
            # stacked tails are this step's inputs.
            tail_k, tail_v = st[1], st[2]
            self._tail_stack = None
        else:
            self._flush_tail_stack()
            z = torch.zeros_like(batch[0].tail_k)
            tail_k = torch.cat([s.tail_k for s in batch] + [z] * pad_b, 1)
            tail_v = torch.cat([s.tail_v for s in batch] + [z] * pad_b, 1)
        table += [[0] * (len(table[0]) if table else 0)] * pad_b
        tab_key = (b_pad, len(table[0]), tuple(map(tuple, table)))
        if self._tab_cache[0] != tab_key:
            self._tab_cache = (tab_key, self._ids(table))
        j0 = time.perf_counter()
        logits, ntk, ntv = self._decode_batch(
            batch, (self._ids(toks), self._ids(metas), pool_k, pool_v,
                    self._tab_cache[1], tail_k, tail_v),
            {2: pool_key, 3: pool_key, 4: tab_key})
        # One argmax and one transfer for the whole batch (first maximum,
        # as the per-session argmax); it is also the step's sync.
        best = torch.argmax(logits, dim=-1).tolist()
        obs_journal.phase("step", time.perf_counter() - j0,
                          priority=max(s.priority for s in batch))
        dt = time.perf_counter() - t0
        self.stats.note_batch_step(len(batch), dt)
        obs_journal.record("batch_step", size=len(batch), pad=b_pad,
                           pages=len(table[0]), ms=round(dt * 1e3, 3))
        self._tail_stack = (list(batch), ntk, ntv)
        for b, (sess, tok, prefill) in enumerate(zip(batch, toks, prefills)):
            # Tails stay stacked; a session takes its own copy only when
            # something reads it.
            sess.tail_k = sess.tail_v = None
            sess.pos += 1
            sess.tail_len += 1
            sess.page_toks.append(int(tok))
            if not prefill or sess.prompt_consumed == len(sess.prompt):
                sess.out.append(int(best[b]))
                self._note_first_token(sess)
                if not prefill:
                    self.stats.note_tokens(1)
            if sess.tail_len == P:
                sess.tail_k, sess.tail_v = _own(ntk[:, b:b + 1]), _own(ntv[:, b:b + 1])
                self._ship(sess)
                self._match_more(sess)
            elif (self.share_partials and prefill
                  and sess.prompt_consumed == len(sess.prompt)):
                sess.tail_k, sess.tail_v = _own(ntk[:, b:b + 1]), _own(ntv[:, b:b + 1])
                self._publish_partial(sess)
            if len(sess.out) > sess.req.max_new_tokens:
                raise AssertionError("overran max_new_tokens")
            if len(sess.out) == sess.req.max_new_tokens:
                sess.done = True

    def _flush_tail_stack(self) -> None:
        """Give every session of the last step its own tail copy out of
        the stacked tails (membership changed)."""
        st = self._tail_stack
        if st is None:
            return
        self._tail_stack = None
        sessions, ntk, ntv = st
        for b, sess in enumerate(sessions):
            if sess.tail_k is None:
                sess.tail_k, sess.tail_v = _own(ntk[:, b:b + 1]), _own(ntv[:, b:b + 1])

    def _ship(self, sess: _Session) -> None:
        """Page boundary: the full tail becomes a stored page: the pending
        CoW clone when one is open, a published shared extent for a
        prompt-only page, a private page otherwise."""
        raw = to_bytes(torch.stack([sess.tail_k, sess.tail_v])
                       .to(torch_dtype(self.store_dtype)))
        arrays = (sess.tail_k, sess.tail_v)
        prompt_only = sess.pos <= len(sess.prompt)
        pending = next((e for e in sess.entries if e.pending_fill), None)
        if pending is not None:
            self.store.write_page(pending.page, raw)
            entry = pending
            entry.pending_fill = False
        else:
            entry = _Entry(page=self.store.alloc_page(raw))
            sess.entries.append(entry)
        if (self.prefix is not None and prompt_only and sess.chain_valid
                and not entry.page.shared):
            ext = self.prefix.publish(sess.chain_parent,
                                      tuple(sess.page_toks), entry.page)
            entry.page = ext.page  # dedup may have swapped in the winner
            entry.extent = ext
            self.prefix.acquire(ext)
            sess.shared_refs.append(ext)
            sess.chain_parent = ext
        elif not prompt_only:
            sess.chain_valid = False  # generated content: never published
        entry.arrays = arrays
        entry.version = entry.page.version
        sess.reset_tail()

    def _publish_partial(self, sess: _Session) -> None:
        """End of prefill mid-page: publish the prompt's partial tail as a
        shareable extent (this session keeps decoding in its own tail)."""
        if (self.prefix is None or not sess.chain_valid
                or sess.tail_len == 0 or sess.pos > len(sess.prompt)):
            return
        raw = to_bytes(torch.stack([sess.tail_k, sess.tail_v])
                       .to(torch_dtype(self.store_dtype)))
        page = self.store.alloc_page(raw)
        self.prefix.publish(sess.chain_parent,
                            tuple(sess.page_toks[:sess.tail_len]), page)

    def _finish(self, sess: _Session, abandon: bool = False) -> None:
        for ext in sess.shared_refs:
            self.prefix.release(ext)
        sess.shared_refs = []
        for e in sess.entries:
            if e.extent is None and not e.page.shared and not e.page.freed:
                self.store.free_page(e.page)
        sess.entries = []
        if not abandon:
            self.results.append(SessionResult(
                tenant=sess.req.tenant,
                prompt_len=len(sess.prompt),
                out_tokens=list(sess.out),
                stall_s=round(sess.stall_s, 6),
                prefix_tokens_reused=sess.prefix_tokens_reused,
            ))

    # -- introspection ----------------------------------------------------

    def metrics_meta(self) -> dict:
        meta = self.stats.snapshot()
        meta["prefetch"]["mode"] = self.prefetcher.mode
        if self.prefix is not None:
            meta["prefix"]["shared_bytes_live"] = self.prefix.shared_bytes()
        meta["cold_sim"] = self.store.cold_sim
        if self.graphs is not None:
            meta["graphs"] = {"captured": self.graphs.captured,
                              "steps": len(self.graphs.steps),
                              "capture_s": round(self.graphs.capture_s, 6)}
        return meta
