"""The port's bench orchestration (``benchmarks/bench.run``) with the heavy
stages stubbed: the JAX package's three cases (tests/
test_bench_orchestration.py) on the port. Every expensive stage is a
cheap stand-in and the REAL ``run`` drives the REAL banking logic end to
end (the copy legs run for real, at a tiny size on the CPU): the full
budget banks every stage and the grader's dcn row passes, a truncated
budget still banks the cheap graded stages and the early wire echo, and a
failed tail re-run keeps the early echo (``bank_dcn``)."""

import pytest

from oncilla_tpu_torch.benchmarks import bench, ceiling, check, gups, kv_decode, mfu
from test_torch_bench import BENCH_TINY


@pytest.fixture()
def stubbed(monkeypatch):
    monkeypatch.setattr(ceiling, "ceiling_probe", lambda **kw: {
        "read_only_gbps": 700.0, "copy_streams_gbps": {"2": 580.0},
        "vmem_roundtrip_gbps": 150.0})
    monkeypatch.setattr(bench, "bench_gb_sweep", lambda errors, seconds=0, **kw: {
        "1073741824": [None, 6.0, 400.0]})
    monkeypatch.setattr(bench, "bench_dcn", lambda errors, **kw: {
        "put_gbps": 1.9, "get_gbps": 1.2, "unit": "Gbit/s", "verified": True})
    monkeypatch.setattr(mfu, "mfu_forward", lambda **kw: {"mfu": 0.65, "tflops": 128.0})
    monkeypatch.setattr(mfu, "mfu_train_best", lambda **kw: {
        "mfu": 0.61, "tflops": 120.0, "variants": [{"mfu": 0.61}]})
    monkeypatch.setattr(gups, "gups_handle_best", lambda **kw: {
        "gups": 0.08, "mode": "handle:bincount", "updates": 64, "table_sum": 64})
    monkeypatch.setattr(bench, "bench_serving", lambda errors, **kw: {
        "chaos": {"byte_exact": True}, "warmboot": {"byte_exact": True}})
    monkeypatch.setattr(kv_decode, "run_bench", lambda **kw: {
        "tok_s": {"plain": 500.0, "device_fused": 1700.0},
        "paging_overhead": {"device_fused": 0.48}})
    return bench


def _drive(budget_s: float):
    return bench.run("cpu", deadline_s=budget_s, timing=False,
                     copy_kw=BENCH_TINY["copy_kw"])


def test_full_budget_banks_every_stage(stubbed):
    out = _drive(3600.0)
    d = out["detail"]
    assert out["ok"] is True and d["errors"] == {}
    for key in ("ceiling", "gb_sweep", "dcn", "mfu", "mfu_train",
                "mfu_train_variants", "gups", "gups_method", "serving",
                "kv_decode_tok_s", "onesided_verified", "dma_rows_verified"):
        assert key in d, (key, sorted(d))
    assert d["dcn"]["verified"] is True
    assert list(d["stage_s"]) == ["copy_legs", "ceiling", "gb_sweep", "dcn_early",
                                  "mfu_forward", "mfu_train", "gups", "serving",
                                  "kv_decode", "dcn_tail"]
    verdicts = {name: v for name, v, _ in check.grade(out)}
    assert verdicts["ceiling probe banked (read_only + stream sweep)"] == "PASS"
    assert verdicts["dcn banked and verified"] == "PASS"


def test_without_the_tail_the_wire_runs_once(stubbed, monkeypatch):
    """``dcn_tail=False`` (chip_smoke.py's bench): the early echo is banked
    and graded, the wire runs once."""
    calls = []
    monkeypatch.setattr(bench, "bench_dcn", lambda errors, **kw: calls.append(1) or {
        "put_gbps": 1.9, "get_gbps": 1.2, "unit": "Gbit/s", "verified": True})
    out = bench.run("cpu", deadline_s=3600.0, timing=False,
                    copy_kw=BENCH_TINY["copy_kw"], dcn_tail=False)
    assert out["ok"] is True and len(calls) == 1
    verdicts = {name: v for name, v, _ in check.grade(out)}
    assert verdicts["dcn banked and verified"] == "PASS"


def test_truncated_budget_still_banks_cheap_graded_stages(stubbed):
    """With ~9 minutes of budget, the ceiling, the gb_sweep and the early
    wire echo bank whatever the later stages do."""
    out = _drive(560.0)
    d = out["detail"]
    for key in ("ceiling", "gb_sweep", "dcn"):
        assert key in d, (key, sorted(d), d["errors"])
    assert d["dcn"]["verified"] is True


def test_failed_tail_dcn_keeps_early_echo(stubbed, monkeypatch):
    """``bank_dcn``: an unverified tail re-run must not clobber a banked
    verified early echo."""
    calls = [0]

    def flaky_dcn(errors, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return {"put_gbps": 1.9, "get_gbps": 1.2, "verified": True}
        errors["dcn"] = "tail blew up"
        return {}

    monkeypatch.setattr(bench, "bench_dcn", flaky_dcn)
    out = _drive(3600.0)
    assert calls[0] == 2  # early echo + tail both ran
    assert out["detail"]["dcn"]["verified"] is True  # early echo survives
    assert out["detail"]["errors"] == {"dcn": "tail blew up"} and out["ok"] is False
