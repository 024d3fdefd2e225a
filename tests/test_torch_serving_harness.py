"""The port's serving harness (``oncilla_tpu_torch.serving.__main__``) on
the CPU against the JAX package's (``oncilla_tpu/serving/__main__.py``) at
the harness's own tiny sizes: the paired shared/noshare cells, the
batched/interleaved pair and the batched sweep. Both
packages draw the same weights (``init_params_host``) and prompts, so the
tokens are equal; with prefetch workers off every field but the timings is
equal too (with workers on, page moves follow the workers' timing in both
packages, so only the tokens, prefix hits and drained ranks are held).
The chaos and warm-boot legs are in ``test_torch_serving_harness_chaos.py``,
``run_bench`` and chip_smoke's phase 8e in ``test_torch_serving_harness_bench.py``.
"""

import pytest
import torch

from oncilla_tpu.serving import __main__ as jh
from oncilla_tpu_torch.core.errors import OcmDeviceError
from oncilla_tpu_torch.serving import __main__ as ph

SMOKE_FLEET = {"tenants": 4, "shared_tokens": 20, "suffix_tokens": 4,
               "new_tokens": 10, "hot": 3, "warm": 4}
# A cell's fields that are wall-clock times (the rest is counted).
TIMES = ("tok_s", "wall_s", "stall_ms", "ttft")
BATCH_TIMES = ("step_s", "step_s_hist")


@pytest.fixture(autouse=True)
def _quiet_host(monkeypatch):
    """Both packages' alloctrace ledgers start empty, as the harness's smoke
    starts them: a test file run earlier in this process may have left
    ``OCM_ALLOCTRACE`` on and allocations of its own alive, which the
    harness's drain check would read as this cell's leak. And torch keeps
    to one thread, here and in the harness's subprocesses: the tiny model's
    steps run faster on one, and the suite's workers share the host's
    cores (eight torch threads a worker starve the in-process daemons)."""
    from oncilla_tpu.analysis import alloctrace as jtrace
    from oncilla_tpu_torch.analysis import alloctrace as ptrace

    jtrace.reset()
    ptrace.reset()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counted(cell: dict) -> dict:
    out = {k: v for k, v in cell.items() if k not in TIMES}
    out["batch"] = {k: v for k, v in cell["batch"].items() if k not in BATCH_TIMES}
    return out


def _keys(x):
    """The nested key structure of a result, leaves dropped."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    return None


@pytest.mark.parametrize("workers", [0, 2])
def test_run_pair_equals_jax(workers):
    got = ph.run_pair(1234, prefetch_workers=workers, device="cpu", **SMOKE_FLEET)
    want = jh.run_pair(1234, prefetch_workers=workers, **SMOKE_FLEET)
    assert _keys(got) == _keys(want)
    for name in ("shared", "noshare"):
        g, w = got["cells"][name], want["cells"][name]
        assert g["outputs"] == w["outputs"]
        assert g["prefix"] == w["prefix"]
        if workers == 0:
            assert _counted(g) == _counted(w)
    assert got["drained_ranks"] == want["drained_ranks"] == [0, 1, 2]
    assert got["cells"]["shared"]["prefix"]["hits"] > 0
    if workers == 0:
        top = ("remote_bytes_shared", "remote_bytes_noshare", "hit_ratio_delta",
               "prompt_tokens")
        assert {k: got[k] for k in top} == {k: want[k] for k in top}


@pytest.mark.parametrize("workers", [0, 2])
def test_run_batched_pair_equals_jax(workers):
    got = ph.run_batched_pair(1234, prefetch_workers=workers, device="cpu",
                              **SMOKE_FLEET)
    want = jh.run_batched_pair(1234, prefetch_workers=workers, **SMOKE_FLEET)
    assert _keys(got) == _keys(want)
    for name in ("interleaved", "batched"):
        g, w = got["cells"][name], want["cells"][name]
        assert g["outputs"] == w["outputs"]
        if workers == 0:
            assert _counted(g) == _counted(w)
    assert got["batch"]["size_max"] >= 2
    assert got["drained_ranks"] == want["drained_ranks"]


def test_run_batched_sweep_keys_equal_jax():
    kw = {"tenants": 3, "shared_tokens": 8, "suffix_tokens": 2, "new_tokens": 4,
          "hot": 8, "warm": 4, "sizes": (1, 2)}
    got = ph.run_batched_sweep(7, device="cpu", **kw)
    want = jh.run_batched_sweep(7, **kw)
    assert _keys(got) == _keys(want)
    for name, c in got["cells"].items():
        assert _counted(c) == _counted(want["cells"][name])


def test_without_cuda_the_harness_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--smoke"], ["--bench"], ["--batched"]):
        with pytest.raises(OcmDeviceError):
            ph.main(argv)
    assert "OK" not in capsys.readouterr().out
