"""The port's MFU benchmark (``oncilla_tpu_torch.benchmarks.mfu``) on the
CPU: its FLOP counts are the JAX package's integers, its configurations
the same geometry, its grid the same eight variants; the measurements run
at the tiny size (a CPU time, with ``mfu`` None: no bf16 peak for the
CPU); the bf16-µ variant stores µ in bf16 and ν in float32; only running
out of device memory is recorded as a variant's result."""

import dataclasses

import pytest
import torch

from oncilla_tpu.benchmarks import mfu as jmfu
from oncilla_tpu.models.llama import LlamaConfig as JConfig
from oncilla_tpu_torch.benchmarks import mfu
from oncilla_tpu_torch.core.errors import OcmDeviceError
from oncilla_tpu_torch.models import train
from oncilla_tpu_torch.models.llama import LlamaConfig
from oncilla_tpu_torch.utils import platform

TINY = LlamaConfig.tiny()


def _as_jax(cfg) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("which", ["tiny", "train", "chip"])
def test_flop_counts_are_the_jax_integers(which):
    if which == "tiny":
        cfg, b, s = TINY, 3, 17
    else:
        cfg, b, s = (mfu.train_sized_config() if which == "train"
                     else mfu.chip_filling_config())
    jcfg = _as_jax(cfg)
    assert mfu.forward_flops(cfg, b, s) == jmfu.forward_flops(jcfg, b, s)
    assert mfu.train_flops(cfg, b, s) == jmfu.train_flops(jcfg, b, s)
    assert isinstance(mfu.train_flops(cfg, b, s), int)


def test_configs_are_the_jax_geometry():
    for ours, theirs in ((mfu.chip_filling_config(), jmfu.chip_filling_config()),
                         (mfu.train_sized_config(), jmfu.train_sized_config())):
        assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
        assert ours[1:] == theirs[1:]


def test_variant_grid_is_the_jax_grid():
    ours = [mfu.variant_label(v) for v in mfu.train_variants()]
    theirs = [jmfu.variant_label(v) for v in jmfu.train_variants()]
    assert ours == theirs and len(ours) == 8


def test_peak_is_the_datasheet_dense_bf16_rate(monkeypatch):
    monkeypatch.delenv("OCM_PEAK_TFLOPS", raising=False)
    assert platform.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert platform.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert platform.peak_flops("NVIDIA H100 NVL") == 835e12
    with pytest.raises(OcmDeviceError):
        platform.peak_flops("a card with no row")
    monkeypatch.setenv("OCM_PEAK_TFLOPS", "500")
    assert platform.peak_flops("NVIDIA H100 80GB HBM3") == 500e12


def test_mfu_forward_and_train_run_on_the_cpu():
    fwd = mfu.mfu_forward(TINY, 2, 16, steps=2, device="cpu")
    assert fwd["mfu"] is None and fwd["tflops"] > 0 and fwd["device"] == "cpu"
    assert fwd["flops_per_step"] == mfu.forward_flops(TINY, 2, 16)
    for fold in (False, True):
        r = mfu.mfu_train(TINY, 2, 16, steps=2, remat="dots", ce_block=8,
                          mu_dtype=torch.bfloat16, fold=fold, device="cpu")
        assert r["mfu"] is None and r["tflops"] > 0 and r["fold"] is fold
        assert r["mu_dtype"] == "bfloat16" and r["remat"] == "dots"
        assert r["loss"] == r["loss"]  # finite, not NaN


def test_bf16_mu_variant_stores_mu_in_bf16_and_nu_in_fp32(monkeypatch):
    seen = []
    real = train.make_train_step

    def spy(cfg, tx, **kw):
        step = real(cfg, tx, **kw)

        def wrapped(params, opt_state, tokens):
            seen.append((opt_state[0].mu["wq"].dtype, opt_state[0].nu["wq"].dtype))
            return step(params, opt_state, tokens)

        return wrapped

    monkeypatch.setattr(train, "make_train_step", spy)
    variant = dict(batch=2, remat=False, ce_block=None, mu_dtype=torch.bfloat16, fold=True)
    best = mfu.mfu_train_best(variants=[variant], device="cpu", cfg=TINY, seq=16)
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    assert best["variants"][0]["mu_dtype"] == "bfloat16"


def _tiny_variants():
    return [dict(batch=2, remat=False, ce_block=None, mu_dtype=None),
            dict(batch=2, remat="dots", ce_block=8, mu_dtype=torch.bfloat16, fold=True)]


def test_mfu_train_best_keeps_the_fastest_and_records_oom(monkeypatch):
    real = mfu.mfu_train

    def oom_on_dots(cfg, batch, seq, remat=False, **kw):
        if remat == "dots":
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(cfg, batch, seq, remat=remat, **kw)

    monkeypatch.setattr(mfu, "mfu_train", oom_on_dots)
    best = mfu.mfu_train_best(variants=_tiny_variants(), device="cpu", cfg=TINY, seq=16)
    assert best["remat"] == "False"
    assert best["variants"][1] == {**mfu.variant_label(_tiny_variants()[1]),
                                   "error": "OutOfMemoryError"}


def test_a_non_oom_error_in_a_variant_propagates(monkeypatch):
    def broken(*a, **kw):
        raise ValueError("a bug, not a memory limit")

    monkeypatch.setattr(mfu, "mfu_train", broken)
    with pytest.raises(ValueError, match="a bug"):
        mfu.mfu_train_best(variants=_tiny_variants(), device="cpu", cfg=TINY, seq=16)


def test_a_passed_deadline_skips_every_variant():
    with pytest.raises(RuntimeError, match="'skipped': 'deadline'"):
        mfu.mfu_train_best(deadline=0.0, variants=_tiny_variants(), device="cpu",
                           cfg=TINY, seq=16)
