"""bench.py's measurement path in the port, on the CPU.

- The port's grader (``benchmarks/check.grade``) gives the JAX grader's
  verdicts on the same documents, keys translated: ``vs_baseline`` (value
  over 0.8 x 819 GB/s) becomes ``vs_hbm`` (value over the card's memory
  rate, target 0.80), ``pallas_gbps`` becomes ``copy_loop_gbps``.
- ``benchmarks/bench.run`` and ``chip_smoke.phase_bench`` (phase 7)
  rehearsed at tiny sizes with timing off, the mfu stages on the tiny
  Llama, the wire legs at 8 MiB, GUPS on a 1024-word table and the serving
  harness's ``--bench`` in a subprocess on the CPU; a wrong plain loop
  zeroes its number, and a kernel that disagrees with its plain version
  fails phase 7.
- Without CUDA the bench refuses.
"""

import copy
import json

import pytest
import torch

import chip_smoke
from oncilla_tpu_torch.models.llama import LlamaConfig
import oncilla_tpu_torch as tocm
from oncilla_tpu.benchmarks import check as jcheck
from oncilla_tpu_torch.benchmarks import bench, check
from oncilla_tpu_torch.ops import ceiling_loops, copy_loops

KiB = 1 << 10
MiB = 1 << 20

HEALTHY = {
    "value": 700.0, "vs_baseline": 1.07,
    "detail": {
        "pallas_gbps": 580.0,
        "gb_sweep": {"1073741824": [5.0, 400.0]},
        "ceiling": {"read_only_gbps": 750.0, "vmem_roundtrip_gbps": 366.0},
        "mfu_train": 0.61, "mfu_train_variants": [{}],
        "kv_decode_tok_s": {"device_fused": 120.0, "plain": 100.0},
        "dcn": {"verified": True},
    },
}


def _variant(**changes):
    doc = copy.deepcopy(HEALTHY)
    for key, value in changes.items():
        if key in ("value", "vs_baseline"):
            doc[key] = value
        else:
            doc["detail"][key] = value
    return doc


DOCS = {
    "wedge": {"value": 0.0, "vs_baseline": 0.0, "detail": {}},
    "healthy": HEALTHY,
    "headline_short": _variant(vs_baseline=0.9),
    "headline_at_target": _variant(vs_baseline=1.0),
    "weak_read": _variant(gb_sweep={"1073741824": [5.0, 14.0]}, mfu_train=0.55),
    "amortized": _variant(gb_sweep={"536870912": [5.0, 6.0, 410.0],
                                    "1073741824": [None, 6.2, 395.0],
                                    "dropped": [2097152]}),
    "largest_size": _variant(gb_sweep={"268435456": [None, 100.0, 250.0],
                                       "536870912": [None, 100.0, 300.0]}),
    "partial_ceiling": _variant(ceiling={"read_only_gbps": 750.0,
                                         "vmem_roundtrip_gbps": -1.0}),
    "slow_fused": _variant(kv_decode_tok_s={"device_fused": 90.0, "plain": 100.0}),
    "dcn_unverified": _variant(dcn={"verified": False}),
    "no_loop": _variant(pallas_gbps=0.0),
}


def _to_port(doc: dict) -> dict:
    """The JAX bench line in the port's keys."""
    out = copy.deepcopy(doc)
    out["vs_hbm"] = out.pop("vs_baseline") * 0.8
    d = out["detail"]
    if "pallas_gbps" in d:
        d["copy_loop_gbps"] = d.pop("pallas_gbps")
    return out


@pytest.mark.parametrize("name", list(DOCS))
def test_grade_agrees_with_the_jax_grader(name):
    want = [v for _, v, _ in jcheck.grade(DOCS[name])]
    got = [v for _, v, _ in check.grade(_to_port(DOCS[name]))]
    assert got == want and len(got) == 6


def test_check_main_grades_a_file(tmp_path, capsys):
    path = tmp_path / "line.json"
    path.write_text("log line\n" + json.dumps(_to_port(HEALTHY)) + "\n")
    assert check.main(["check", str(path)]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 6
    path.write_text(json.dumps(_to_port(DOCS["weak_read"])))
    assert check.main(["check", str(path)]) == 1
    assert check.main(["check"]) == 2


CEILING_TINY = {
    "read_kw": {"total_bytes": 256 * KiB, "chunk_bytes": 64 * KiB, "iters": 2},
    "copy_kw": {"total_bytes": 256 * KiB, "nbytes": 64 * KiB, "iters": 3},
    "roundtrip_kw": {"total_bytes": 256 * KiB, "nbytes": 64 * KiB, "iters": 3,
                     "chunk_bytes": 32 * KiB},
}
BENCH_TINY = {
    "copy_kw": {"arena_bytes": 1 * MiB, "nbytes": 32 * KiB, "iters": 4,
                "alloc_iters": 10},
    "ceiling_kw": CEILING_TINY,
    "gb_kw": {"arena_bytes": 4 * MiB,
              "ranges": ((1 * MiB, 2 * MiB, 1, 0.65, 1 * MiB, True),
                         (1 * KiB, 64 * KiB, 2, 0.35, None, False))},
    "kv_kw": {"tokens_n": 8, "page_tokens": 4, "config": "tiny"},
    "dcn_kw": {"nbytes": 8 * MiB},
    "gups_kw": {"words": 1 << 10, "batch": 256, "steps": 4},
    "mfu_kw": {
        "forward": {"cfg": LlamaConfig.tiny(), "batch": 2, "seq": 16, "steps": 1},
        "train": {"cfg": LlamaConfig.tiny(), "seq": 16, "variants": [
            {"batch": 2, "remat": "dots", "ce_block": 8, "mu_dtype": torch.bfloat16,
             "fold": True},
            {"batch": 2, "remat": False, "ce_block": None, "mu_dtype": None}]},
    },
}


def test_gb_ranges_are_bench_py_ranges():
    assert bench.GB_ARENA == (2 << 30) + (256 << 20)
    assert [r[:3] + r[4:] for r in bench.GB_RANGES] == [
        (128 << 20, 1 << 30, 1, 256 << 20, True), (1 << 10, 64 << 20, 4, None, False)]
    assert [r[3] for r in bench.GB_RANGES] == [0.65, 0.35]


def test_bench_rehearsal_on_the_cpu(monkeypatch):
    # One torch thread here and in the harness's subprocess: the tiny
    # models run faster on one, and the test workers share the host.
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # The tail re-runs the early wire leg's code: one real run banks both
    # (bank_dcn's rules are test_torch_bench_orchestration's), and the
    # workers are spared four more Python daemon pairs.
    real_dcn, wire = bench.bench_dcn, []

    def wire_once(errors, **kw):
        if not wire:
            wire.append(real_dcn(errors, **kw))
        return dict(wire[0])

    monkeypatch.setattr(bench, "bench_dcn", wire_once)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = bench.run("cpu", timing=False, **BENCH_TINY)
    finally:
        torch.set_num_threads(threads)
    d = out["detail"]
    assert out["ok"] is True and list(out)[-1] == "ok"
    assert out["value"] is None and out["vs_hbm"] is None  # no CPU rate
    assert d["errors"] == {}  # every stage ran, bench.py's last three too
    # The mfu stages ran at the tiny size; no CPU number stands as a rate.
    assert d["mfu"] is None and d["mfu_forward_tflops"] is None
    assert d["mfu_train"] is None and d["mfu_train_tflops"] is None
    assert [(v["remat"], v["fold"], v["mfu"]) for v in d["mfu_train_variants"]] == [
        ("dots", True, None), ("False", False, None)]
    assert list(d["ceiling"]) == ["read_only_gbps", "copy_streams_gbps",
                                  "vmem_roundtrip_gbps"]
    sizes = [int(k) for k in d["gb_sweep"] if k.isdigit()]
    assert sorted(sizes) == [KiB << i for i in range(7)] + [1 * MiB, 2 * MiB]
    assert all(v == [None, None, None] for k, v in d["gb_sweep"].items() if k.isdigit())
    assert set(d["kv_decode_tok_s"]) == {"plain", "device", "host",
                                         "device_fused", "fused"}
    assert d["onesided_verified"] and d["dma_rows_verified"]
    assert list(d["stage_s"]) == ["copy_legs", "ceiling", "gb_sweep", "dcn_early",
                                  "mfu_forward", "mfu_train", "gups", "serving",
                                  "kv_decode", "dcn_tail"]
    # The wire legs: the stripe sweep on the native daemons, the fabric and
    # daemon sweeps beside it, every cell read back equal, in Gbit/s.
    dcn = d["dcn"]
    assert dcn["verified"] and dcn["native_daemons"] and dcn["unit"] == "Gbit/s"
    assert dcn["fabric"]["verified"] and dcn["native"]["verified"]
    assert d["gups"] is None  # no CPU rate
    assert d["gups_method"].startswith("handle:")
    assert d["gups_table_sum"] == d["gups_updates"] == 4 * 256
    serving = d["serving"]
    assert serving["chaos"]["byte_exact"] and serving["warmboot"]["byte_exact"]
    assert serving["drained_ranks"] == [0, 1, 2]
    # Only the wire row grades on the CPU: it holds no rate of the card.
    assert [v for _, v, _ in check.grade(out)] == ["NO DATA"] * 5 + ["PASS"]


def test_bench_wrong_plain_loop_zeroes_its_number(monkeypatch):
    real = copy_loops.copy_loop_plain

    def wrong(buf, nbytes, iters, streams=2):
        real(buf, nbytes, iters, streams)
        if streams == 1:  # the plain leg; the loops K9/K10 stay right
            buf.view(-1)[0] += 1  # the leg runs more than once: no xor
        return buf

    monkeypatch.setattr(copy_loops, "copy_loop_plain", wrong)
    # The wire and serving legs' own work is the rehearsal's.
    monkeypatch.setattr(bench, "bench_dcn", lambda errors, **kw: {"verified": True})
    monkeypatch.setattr(bench, "bench_serving", lambda errors, **kw: {})
    out = bench.run("cpu", timing=False, **BENCH_TINY)
    d = out["detail"]
    assert out["ok"] is False and list(out)[-1] == "ok"
    assert d["plain_loop_gbps"] == 0.0
    assert d["errors"]["plain_loop_correctness"] == "plain loop mismatch"
    assert d["copy_loop_gbps_s2"] is None  # checked, right, untimed


@pytest.mark.parametrize("deadline_s,skipped", [
    # each stage's need: bench.py's 150/60/45/240/240/120/150/200/60 s
    (100.0, ("ceiling", "mfu_forward", "mfu_train", "gups", "serving", "kv_decode")),
    (50.0, ("ceiling", "gb_sweep", "mfu_forward", "mfu_train", "gups", "serving",
            "kv_decode", "dcn_tail")),
])
def test_bench_stages_past_the_budget_are_skipped(deadline_s, skipped, monkeypatch):
    # The wire legs' own work is the rehearsal's; here they bank at once.
    monkeypatch.setattr(bench, "bench_dcn", lambda errors, **kw: {"verified": True})
    out = bench.run("cpu", deadline_s=deadline_s, timing=False, **BENCH_TINY)
    d = out["detail"]
    assert out["ok"] is False
    for stage, key in (("ceiling", "ceiling"), ("gb_sweep", "gb_sweep"),
                       ("mfu_forward", "mfu"), ("mfu_train", "mfu_train"),
                       ("gups", "gups"), ("serving", "serving"),
                       ("kv_decode", "kv_decode_tok_s")):
        if stage in skipped:
            assert d["errors"][stage].startswith("skipped:") and key not in d
        else:
            assert stage not in d["errors"] and key in d
    # The early wire echo banks within either budget; the tail re-runs only
    # where 60 s are left.
    assert d["dcn"] == {"verified": True} and "dcn_early" not in d["errors"]
    assert ("dcn_tail" in d["errors"]) == ("dcn_tail" in skipped)
    assert d["copy_loop_streams"] == 2  # the copy legs always run


def _phase(**kw):
    return chip_smoke.phase_bench(
        torch.device("cpu"), 3.35e12, CEILING_TINY["read_kw"], CEILING_TINY["copy_kw"],
        CEILING_TINY["roundtrip_kw"], bench_kw=BENCH_TINY, gb_max=2 * MiB,
        timing=False, check_launches=False, **kw)


def test_chip_smoke_bench_phase_rehearsal_on_the_cpu(monkeypatch):
    # The wire and serving legs bank stand-ins here: their own work is
    # test_bench_rehearsal_on_the_cpu's; the phase's checks read these.
    monkeypatch.setattr(bench, "bench_dcn", lambda errors, **kw: {
        "verified": True, "native_daemons": True})
    monkeypatch.setattr(bench, "bench_serving", lambda errors, **kw: {
        "chaos": {"byte_exact": True}, "warmboot": {"byte_exact": True},
        "launches": {"write_rows": 0, "read_rows": 0}})
    r = _phase()
    assert set(r["rows"]) == {"read_stream", "copy_stream_loop", "vmem_roundtrip"}
    for name, rows in r["rows"].items():
        assert rows[0]["bound_ms"] > 0 and rows[0]["max_abs_err"] == 0.0
    assert [c["streams"] for c in r["rows"]["copy_stream_loop"][1:]] == [1, 2, 4, 8]
    assert [c["iters"] for c in r["rows"]["vmem_roundtrip"][1:]] == [2, 3]
    assert r["bench"]["ok"] and len(r["grade"]) == 6
    assert r["grade"][5][1] == "PASS"  # the wire legs, verified
    assert set(r["launches_serving"]) >= {"write_rows", "read_rows"}


def test_chip_smoke_bench_phase_catches_a_wrong_kernel(monkeypatch):
    real = ceiling_loops.vmem_roundtrip

    def wrong(buf, nbytes, iters, chunk_bytes=2 << 20):
        real(buf, nbytes, iters, chunk_bytes)
        buf.view(-1)[nbytes + 5] ^= 7
        return buf

    monkeypatch.setattr(ceiling_loops, "vmem_roundtrip", wrong)
    with pytest.raises(AssertionError, match="vmem_roundtrip .* differs from its plain"):
        _phase()


def test_without_cuda_the_bench_refuses(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tocm.OcmDeviceError):
        bench.main()
    with pytest.raises(tocm.OcmDeviceError):
        bench.run(None, timing=False, **BENCH_TINY)
    assert '"ok"' not in capsys.readouterr().out
