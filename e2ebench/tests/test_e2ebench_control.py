"""The control: the reference in float8 e4m3 in the program's place. On
the CPU its rounding and its reading at tiny widths; on the card, each
cell at its own widths for one short window, where the control's mean gap
has to fail the cell's limit and the program's has to hold it (the full
readings the limits were set from: ``calibrate.py``, PERF.md)."""

import json
from pathlib import Path

import pytest
import torch

from e2ebench.reference.decoder import E4M3_MAX, to_e4m3
from e2ebench.tests.test_e2ebench_harness import CELLS, REHEARSED
from e2ebench.tests.tiny import run_tiny

HERE = Path(__file__).resolve().parents[1]


def test_float8_rounding_keeps_three_mantissa_bits():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(5))
    q = to_e4m3(x, -1)
    scale = x.abs().amax(-1, keepdim=True) / E4M3_MAX
    assert torch.equal((x / scale).to(torch.float8_e4m3fn).float() * scale, q)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0 < float(rel.max()) <= 2 ** -4 + 1e-6


@pytest.mark.parametrize("workload", REHEARSED)
def test_the_control_reads_beside_the_program(workload):
    out = run_tiny(workload, seed=7, cfg={"torch_dtype": "bfloat16"},
                   control=True)
    cal = out["calibration"]
    assert cal["tokens"] > 0
    assert set(cal["served"]) == set(cal["control"]) >= {"mean", "widest"}
    assert cal["control"]["mean"] >= 0 and cal["served"]["mean"] >= 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limit_on_the_card(workload, card):
    from e2ebench import run

    limit = json.loads((HERE / "cells" / f"{workload}.json").read_text())["mean_gap"]
    out = run.run(workload, 3000000099, 30.0, False, control=True)
    cal = out["calibration"]
    assert cal["served"]["mean"] <= limit < cal["control"]["mean"], cal
