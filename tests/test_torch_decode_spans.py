"""The paged decode step's spans (``models/kv_paging.py``, ``models/moe.py``)
on the CPU, at a tiny MoE size through ``BucketedPagedDecoder(refetch=True)``.

- Under ``torch.profiler`` one ``generate_page`` of P tokens and L layers is
  P ``ocm:decode_token_step`` ranges, each holding L ``ocm:attention`` and L
  ``ocm:moe_ffn`` ranges, then one ``ocm:kv_store_page`` and one
  ``ocm:kv_fetch_pages``, with the context's ``ocm:put`` and ``ocm:get``
  inside them.
- ``GLOBAL_TRACER`` counts the same spans, profiler or not.
- The profiler changes nothing the decoder computes: sampled ids and logits
  are bit-equal with and without it.
- Without a profiler no range is entered.
"""

import contextlib

import pytest
import torch

import oncilla_tpu_torch as ocm
from oncilla_tpu_torch import OcmKind
from oncilla_tpu_torch.models import kv_paging, moe
from oncilla_tpu_torch.utils.debug import GLOBAL_TRACER

PAGE, BATCH, PAGES = 4, 2, 3
SPANS = ("decode_token_step", "attention", "moe_ffn", "kv_store_page",
         "kv_fetch_pages")
CFG = moe.MoeConfig.tiny()


def _counts() -> dict:
    return {op: GLOBAL_TRACER.stats(op).count for op in SPANS}


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _decode(profiled: bool):
    """A page of teacher-forced prompt, then ``PAGES`` generated pages;
    when ``profiled``, the prompt page and the second generated page run
    under ``torch.profiler``. Returns (prompt logits, generated ids, the
    second page's profiler or None, span counts over that page)."""
    params = moe.init_moe_params(CFG, torch.Generator().manual_seed(3), "cpu")
    ctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=16 << 20,
                                     device_arena_bytes=16 << 20), device="cpu")
    dec = kv_paging.BucketedPagedDecoder(
        params, CFG, ctx, batch=BATCH, page_tokens=PAGE,
        kind=OcmKind.LOCAL_DEVICE, dtype="float32", refetch=True,
        **moe.paged_hooks(CFG))
    prompt = torch.randint(0, CFG.vocab, (BATCH, PAGE),
                           generator=torch.Generator().manual_seed(5))
    prof, counted = None, None
    try:
        with torch.no_grad():
            with _profiler() if profiled else contextlib.nullcontext():
                logits = dec.step_page(prompt)
            token, ids = logits[:, -1].argmax(-1), []
            for p in range(PAGES):
                if not profiled or p != 1:
                    ids.append(dec.generate_page(token))
                else:
                    before = _counts()
                    with _profiler() as prof:
                        ids.append(dec.generate_page(token))
                    after = _counts()
                    counted = {op: after[op] - before[op] for op in SPANS}
                token = ids[-1][:, -1]
    finally:
        dec.close()
        ctx.tini()
    return logits, torch.cat(ids, 1), prof, counted


def _ranges(prof) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of the ``ocm:`` ranges, in start order."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("ocm:"))


def _inside(outer, rs):
    return [r for r in rs if outer[0] <= r[0] and r[1] <= outer[1] and r != outer]


@pytest.fixture(scope="module")
def profiled():
    return _decode(profiled=True)


def test_a_generated_page_is_its_token_steps_and_one_page_move(profiled):
    _, _, prof, _ = profiled
    rs = _ranges(prof)
    steps = [r for r in rs if r[2] == "ocm:decode_token_step"]
    assert len(steps) == PAGE
    for s in steps:
        names = [n for _, _, n in _inside(s, rs)]
        assert sorted(names) == sorted(["ocm:attention"] * CFG.n_layers
                                       + ["ocm:moe_ffn"] * CFG.n_layers), names
    for name, nested in (("ocm:kv_store_page", "ocm:put"),
                         ("ocm:kv_fetch_pages", "ocm:get")):
        (move,) = [r for r in rs if r[2] == name]
        assert all(move[1] <= s[0] or s[1] <= move[0] for s in steps)
        assert nested in {n for _, _, n in _inside(move, rs)}
    top = [r for r in rs if not any(o != r and o[0] <= r[0] and r[1] <= o[1]
                                    for o in rs)]
    assert sorted({n for _, _, n in top}) == [
        "ocm:decode_token_step", "ocm:kv_fetch_pages", "ocm:kv_store_page"]


def test_the_tracer_counts_what_the_profiler_saw(profiled):
    _, _, prof, counted = profiled
    seen = {op: sum(n == f"ocm:{op}" for _, _, n in _ranges(prof)) for op in SPANS}
    assert counted == seen
    assert counted == {"decode_token_step": PAGE,
                       "attention": PAGE * CFG.n_layers,
                       "moe_ffn": PAGE * CFG.n_layers,
                       "kv_store_page": 1, "kv_fetch_pages": 1}


def test_the_profiler_changes_no_bit(profiled):
    logits, ids, _, _ = profiled
    logits0, ids0, prof, _ = _decode(profiled=False)
    assert prof is None
    assert torch.equal(logits, logits0) and torch.equal(ids, ids0)
    assert ids.shape == (BATCH, PAGES * PAGE)


def test_no_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    before = _counts()
    _decode(profiled=False)
    after = _counts()
    assert entered == []
    # every span ran all the same: the prompt page's steps, then the pages
    assert after["decode_token_step"] - before["decode_token_step"] == (
        PAGES + 1) * PAGE
    assert after["kv_fetch_pages"] - before["kv_fetch_pages"] == PAGES + 1
