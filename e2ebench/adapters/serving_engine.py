"""Adapter of the chat-session mixes: closed-loop chat clients through
``oncilla_tpu_torch.serving.ServingEngine`` over a ``TieredPageStore`` and
a ``PrefixCache``.

It submits with ``ServingEngine.submit`` and advances the engine by the
loop that ``run()`` itself runs (``_tick``). After every tick it stamps
each request's newly emitted tokens with the host clock: a token reaches
the client when the tick that made it returns. A finished request's
answer joins its conversation and the client's next turn is submitted at
once (think time 0). ``_tick`` is the one private name it calls; it reads
the public ``active``, ``results``, ``graphs`` and the store's ``stats``.
"""

from __future__ import annotations

import time

import torch

from e2ebench import families, gen


class Request:
    """What the client knows of one request."""

    __slots__ = ("rid", "client", "prompt", "new", "submit_t", "stamps",
                 "out", "done_t", "computed", "pos", "reused")

    def __init__(self, rid, client, prompt, new, submit_t):
        self.rid, self.client, self.prompt, self.new = rid, client, prompt, new
        self.submit_t = submit_t
        self.stamps: list[float] = []
        self.out: list[int] = []
        self.done_t = None
        self.computed = []   # (first position, tokens) computed by a tick
        self.pos = 0
        self.reused = 0


class Adapter:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, params: dict,
                 log):
        import oncilla_tpu_torch as ocm
        from oncilla_tpu_torch.serving.engine import ServingEngine
        from oncilla_tpu_torch.serving.metrics import ServingStats
        from oncilla_tpu_torch.serving.prefix import PrefixCache
        from oncilla_tpu_torch.serving.tiers import TieredPageStore

        self.cfg, self.mix, self.seed, self.device, self.log = (
            cfg, mix, seed, device, log)
        family = families.of(cfg)
        self.pcfg = family.port_config(cfg)
        e = mix["engine"]
        page = ServingEngine.page_nbytes(self.pcfg, e["page_tokens"],
                                         e["store_dtype"])
        self.page_bytes = page
        self.ctx = ocm.ocm_init(ocm.OcmConfig(
            device_arena_bytes=e["hot_pages"] * page,
            host_arena_bytes=(e["warm_pages"] + e["cold_pages"]) * page,
            nodefile=None), device=device)
        self.store = TieredPageStore(
            self.ctx, page, hot_capacity=e["hot_pages"],
            warm_capacity=e["warm_pages"], stats=ServingStats("e2ebench"))
        self.engine = ServingEngine(
            params, self.pcfg, self.store,
            PrefixCache(self.store, e["page_tokens"]),
            page_tokens=e["page_tokens"], max_active=e["max_active"],
            prefetch_workers=e["prefetch_workers"],
            store_dtype=e["store_dtype"], batched=True,
            max_batch=e["max_batch"], name="e2ebench")
        self.clients = gen.chat_clients(mix, seed, family.dims(cfg)["vocab"])
        self.requests: dict[str, Request] = {}
        self.finished: list[Request] = []
        self.ticks = 0
        for c in self.clients:
            self._submit(c)

    # -- the loop ---------------------------------------------------------

    def _submit(self, client) -> None:
        from oncilla_tpu_torch.serving.engine import Request as EngineRequest

        rid, prompt, new = client.next_request()
        req = Request(rid, client, prompt, new, time.perf_counter())
        self.requests[rid] = req
        self.engine.submit(EngineRequest(tenant=rid, tokens=prompt,
                                         max_new_tokens=new))

    def _stamp(self, req: Request, out: list[int], now: float) -> None:
        for t in out[len(req.out):]:
            req.out.append(int(t))
            req.stamps.append(now)

    def _computed(self, req: Request, pos: int, reused: int,
                  now: float) -> None:
        """Positions the tick advanced that were computed, not adopted from
        the prefix cache: (tick end, first position, count)."""
        n = (pos - req.pos) - (reused - req.reused)
        if n > 0:
            req.computed.append((now, pos - n, n))
        req.pos, req.reused = pos, reused

    def tick(self) -> None:
        with torch.profiler.record_function("e2e.tick"):
            self.engine._tick()
        now = time.perf_counter()
        self.ticks += 1
        with torch.profiler.record_function("e2e.client"):
            for sess in self.engine.active:
                req = self.requests[sess.req.tenant]
                self._stamp(req, sess.out, now)
                self._computed(req, sess.pos, sess.prefix_tokens_reused, now)
            results, self.engine.results = self.engine.results, []
            for res in results:
                req = self.requests.pop(res.tenant)
                self._stamp(req, res.out_tokens, now)
                # The last answer token is emitted, never fed back.
                self._computed(req, res.prompt_len + len(res.out_tokens) - 1,
                               res.prefix_tokens_reused, now)
                req.done_t = now
                self.finished.append(req)
                req.client.answered(req.out)
                self._submit(req.client)

    def captured(self) -> int:
        g = self.engine.graphs
        return 0 if g is None else g.captured

    def warm_up(self) -> dict:
        """Run the mix until the graph captures stop growing: at least
        ``min_finished`` requests finished and ``quiet_ticks`` ticks with no
        new capture, or ``max_seconds``. A graph the window still has to
        capture makes the run not correct (``captures_in_window``), so a
        mix sizes these to meet every bucket its traffic can reach."""
        w = self.mix["warmup"]
        t0 = time.perf_counter()
        last, quiet, shown = self.captured(), 0, t0
        while True:
            self.tick()
            if time.perf_counter() - shown > 10:
                shown = time.perf_counter()
                self.log(f"warm-up: {shown - t0:.1f} s, {self.ticks} ticks, "
                         f"{len(self.finished)} finished, {self.captured()} "
                         f"graphs, {self._memory()}")
            n = self.captured()
            quiet = quiet + 1 if n == last else 0
            last = n
            if (len(self.finished) >= w["min_finished"]
                    and quiet >= w["quiet_ticks"]):
                break
            if time.perf_counter() - t0 > w["max_seconds"]:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"ticks": self.ticks, "finished": len(self.finished),
                "captured": self.captured(),
                "seconds": time.perf_counter() - t0}

    def _memory(self) -> str:
        if self.device.type != "cuda":
            return "cpu"
        return (f"allocated {torch.cuda.memory_allocated(self.device)} B, "
                f"reserved {torch.cuda.memory_reserved(self.device)} B")

    def snapshot(self) -> dict:
        """The program's counters and spans at this moment."""
        from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

        st = self.store.stats
        stats = {k: getattr(st, k) for k in (
            "lookups", "hits", "stall_s", "batch_steps")}
        spans = {}
        for op in ("serve_batch_step", "serve_prefill_chunk"):
            st = GLOBAL_TRACER.stats(op)
            spans[op] = (st.count, st.total_s)
        return {"stats": stats, "spans": spans, "captured": self.captured(),
                "t": time.perf_counter()}

    def run(self, seconds: float, stretch=None) -> dict:
        """The measured window: ticks until ``seconds`` have passed.
        ``stretch`` (the traced run) is called between ticks with the
        window's elapsed seconds."""
        s0 = self.snapshot()
        t0 = s0["t"]
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if stretch is not None:
                stretch(now - t0)
            self.tick()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        s1 = self.snapshot()
        self.window = (t0, s1["t"])
        return {"start": s0, "end": s1}

    # -- what the window produced ------------------------------------------

    def samples(self) -> dict:
        """Every sample the end-to-end metrics are taken from."""
        t0, t1 = self.window
        ttft, gaps, tokens = [], [], 0
        for req in self.finished + list(self.requests.values()):
            st = req.stamps
            if st and t0 <= st[0] <= t1:
                ttft.append(st[0] - req.submit_t)
            for a, b in zip(st, st[1:]):
                if t0 <= b <= t1:
                    gaps.append(b - a)
            tokens += sum(t0 <= s <= t1 for s in st)
        return {"ttft_s": ttft, "itl_s": gaps, "tokens": tokens,
                "seconds": t1 - t0}

    def computed_tokens(self) -> list[tuple[int, int]]:
        """(first position, count) of every run of positions that a tick of
        the window computed."""
        t0, t1 = self.window
        return [(p, n) for req in self.finished + list(self.requests.values())
                for t, p, n in req.computed if t0 <= t <= t1]

    def sample(self, rng, want_tokens: int) -> list[tuple[list, list]]:
        """Finished requests to check: the longest finished in the window,
        then others drawn by ``rng`` until ``want_tokens`` served tokens."""
        pool = self._window_done()
        if not pool:
            return []
        pool.sort(key=lambda r: (len(r.prompt) + len(r.out), r.rid))
        picked = [pool.pop()]
        order = rng.permutation(len(pool)).tolist()
        while sum(len(r.out) for r in picked) < want_tokens and order:
            picked.append(pool[order.pop()])
        return [(r.prompt, r.out) for r in picked]

    def _window_done(self) -> list[Request]:
        t0, t1 = self.window
        return [r for r in self.finished if t0 <= r.done_t <= t1]

    def attempted(self) -> int:
        """Requests the window finished."""
        return len(self._window_done())

    def short_answers(self) -> int:
        """Finished requests of the window whose answer is not as long as
        asked (greedy decode ends at ``max_new_tokens``)."""
        return sum(len(r.out) != r.new for r in self._window_done())

    def close(self) -> None:
        self.engine.close()
        self.store.close()
        self.ctx.tini()
        self.engine = self.store = self.ctx = None
