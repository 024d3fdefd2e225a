"""Adapter of the batch-decode mixes: one batch of sequences through
``oncilla_tpu_torch.models.kv_paging.BucketedPagedDecoder`` with the model
family's config and hooks (``port_config``, ``paged_hooks`` of
:mod:`e2ebench.families`; the MoE family's are ``moe.paged_hooks``), its KV
history in OCM pages.

Set-up teacher-forces the seeded prompts a page at a time
(``step_page``, through one ``StepGraphs``) and generates one page to warm
the window's kernels. The window calls ``generate_page`` (greedy) until the
window's seconds have passed; a page is the unit of work, so the window
ends with the page that was running when its time came.
"""

from __future__ import annotations

import time

import torch

from e2ebench import families, gen


class Adapter:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, params: dict,
                 log):
        import oncilla_tpu_torch as ocm
        from oncilla_tpu_torch import OcmKind
        from oncilla_tpu_torch.models import kv_paging
        from oncilla_tpu_torch.models.graphs import StepGraphs

        self.cfg, self.mix, self.seed, self.device, self.log = (
            cfg, mix, seed, device, log)
        family = families.of(cfg)
        self.pcfg = family.port_config(cfg)
        P, B = mix["page_tokens"], mix["batch"]
        self.page_bytes = kv_paging.page_bytes(self.pcfg, P, cfg["torch_dtype"],
                                               B)
        pages = mix["max_context"] // P
        self.ctx = ocm.ocm_init(ocm.OcmConfig(
            device_arena_bytes=pages * self.page_bytes,
            host_arena_bytes=64 << 20, nodefile=None), device=device)
        self.graphs = StepGraphs(params, self.pcfg) if device.type == "cuda" \
            else None
        self.decoder = kv_paging.BucketedPagedDecoder(
            params, self.pcfg, self.ctx, batch=B, page_tokens=P,
            kind=getattr(OcmKind, mix["ocm_kind"]), dtype=cfg["torch_dtype"],
            refetch=mix["refetch"], graphs=self.graphs,
            **family.paged_hooks(self.pcfg))
        self.prompts = torch.from_numpy(
            gen.batch_prompts(mix, seed, family.dims(cfg)["vocab"])).to(device)
        self.served = []               # (B, n) blocks of served ids
        self.pages = []                # (end time, context before, tokens)
        self.next = None

    def warm_up(self) -> dict:
        P = self.mix["page_tokens"]
        t0 = time.perf_counter()
        with torch.no_grad():
            for p in range(self.prompts.shape[1] // P):
                with torch.profiler.record_function("e2e.step_page"):
                    logits = self.decoder.step_page(
                        self.prompts[:, p * P:(p + 1) * P])
            self.next = logits[:, -1].argmax(-1)
            self.served.append(self.next[:, None])
            for _ in range(self.mix["warmup_pages"]):
                self._page()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"captured": self.captured(),
                "seconds": time.perf_counter() - t0,
                "context": self.decoder.pos}

    def captured(self) -> int:
        return 0 if self.graphs is None else self.graphs.captured

    def _page(self) -> None:
        """One page of greedy decode; its first token is the one the last
        page (or the prompt) chose."""
        ctx0 = self.decoder.pos
        with torch.no_grad(), torch.profiler.record_function(
                "e2e.generate_page"):
            out = self.decoder.generate_page(self.next)
            self.next = out[:, -1]  # the last sample seeds the next page
            self.served.append(out)
            out.cpu()  # the page's end, as the host sees it
        self.pages.append((time.perf_counter(), ctx0, out.shape[1]))

    def snapshot(self) -> dict:
        from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

        spans = {}
        for op in ("kv_fetch_pages", "kv_store_page"):
            st = GLOBAL_TRACER.stats(op)
            spans[op] = (st.count, st.total_s)
        return {"spans": spans, "captured": self.captured(),
                "t": time.perf_counter()}

    def run(self, seconds: float, stretch=None) -> dict:
        s0 = self.snapshot()
        t0 = s0["t"]
        limit = self.mix["max_context"] - self.mix["page_tokens"]
        while self.decoder.pos <= limit:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if stretch is not None:
                stretch(now - t0)
            self._page()
        s1 = self.snapshot()
        self.window = (t0, s1["t"])
        return {"start": s0, "end": s1}

    def samples(self) -> dict:
        t0, t1 = self.window
        B = self.mix["batch"]
        tokens = sum(n * B for t, _, n in self.pages if t0 < t <= t1)
        return {"tokens": tokens, "seconds": t1 - t0}

    def computed_tokens(self) -> list[tuple[int, int]]:
        """(first position, count) of the window's token steps, one run a
        row of the batch."""
        t0, t1 = self.window
        B = self.mix["batch"]
        return [(c, n) for t, c, n in self.pages if t0 < t <= t1] * B

    def sample(self, rng, want_tokens: int) -> list[tuple[list, list]]:
        """Rows of the batch drawn by ``rng`` (every row is as long as the
        longest) until ``want_tokens`` served tokens."""
        prompts, served = self.prompts.cpu(), torch.cat(self.served, 1).cpu()
        rows = rng.permutation(self.mix["batch"]).tolist()
        k = max(1, min(len(rows), -(-want_tokens // served.shape[1])))
        return [(prompts[r].tolist(), served[r].tolist()) for r in rows[:k]]

    def attempted(self) -> int:
        return self.mix["batch"]

    def short_answers(self) -> int:
        """Rows that served fewer tokens than the pages generated."""
        served = torch.cat(self.served, 1)
        want = 1 + self.mix["page_tokens"] * len(self.pages)
        return 0 if served.shape[1] == want else self.mix["batch"]

    def close(self) -> None:
        self.decoder.close()
        if self.graphs is not None:
            self.graphs.close()
        self.ctx.tini()
        self.decoder = self.graphs = self.ctx = None

