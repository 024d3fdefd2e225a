"""A run with the timed path broken underneath comes out not correct: the
CPU rehearsal of each cell, and of the chat adapter no cell drives yet
(its harness, adapter, reference and limits, at tiny widths), once for
each fault the cell can have. A cell on one
card exchanges nothing between cards, so that fault has no case here."""

import pytest
import torch

from oncilla_tpu_torch.models import kv_paging, llama
from oncilla_tpu_torch.serving.engine import ServingEngine

from e2ebench.tests.test_e2ebench_harness import REHEARSED
from e2ebench.tests.tiny import run_tiny


def _state_unchanged(monkeypatch):
    """Every token step hands back the tails it was given: the new token's
    K/V is never written."""
    step = kv_paging.paged_token_step

    def broken(params, tokens, meta, k, v, tail_k, tail_v, cfg, *a, **kw):
        logits, _, _ = step(params, tokens, meta, k, v, tail_k.clone(),
                            tail_v.clone(), cfg, *a, **kw)
        return logits, tail_k, tail_v

    monkeypatch.setattr(kv_paging, "paged_token_step", broken)


def _half_batch(monkeypatch):
    """Every token step computes the first half of its rows; the rest take
    the first rows' logits."""
    step = kv_paging.paged_token_step

    def broken(params, tokens, *args, **kw):
        logits, tk, tv = step(params, tokens, *args, **kw)
        B = logits.shape[0]
        if B >= 2:
            keep = (B + 1) // 2
            logits = torch.cat([logits[:keep], logits[:B - keep]])
        return logits, tk, tv

    monkeypatch.setattr(kv_paging, "paged_token_step", broken)


def _altered_token(monkeypatch):
    """One row's token a step, where the step produces it, is the one its
    logits rank last: the engine's first seated row, the decoder's rows in
    turn."""
    decode_batch = ServingEngine._decode_batch
    sample = llama.sample_token

    def engine_broken(self, batch, args, tags):
        logits, tk, tv = decode_batch(self, batch, args, tags)
        logits = logits.clone()
        logits[0] = -logits[0]
        return logits, tk, tv

    steps = iter(range(1 << 30))

    def decoder_broken(logits, *a, **kw):
        tok = sample(logits, *a, **kw).clone()
        row = next(steps) % tok.shape[0]
        tok[row] = logits[row].argmin()
        return tok

    monkeypatch.setattr(ServingEngine, "_decode_batch", engine_broken)
    monkeypatch.setattr(llama, "sample_token", decoder_broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", REHEARSED)
def test_a_broken_step_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_tiny(workload)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", REHEARSED)
def test_the_sound_step_is_correct(workload):
    out = run_tiny(workload)
    assert out["correct"] is True, out["checks"]
