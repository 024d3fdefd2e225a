"""The harness on the CPU: names found, traffic by seed, the arithmetic
over every sample, the reference against the port through the adapters,
the imports, and the last line's keys."""

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from e2ebench import gen, stats, yardstick
from e2ebench.tests.tiny import CHAT, CHAT_MIX, mix_of, run_tiny, spec_of

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "e2ebench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
REHEARSED = CELLS + [CHAT]  # and the chat adapter, which no cell drives yet
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_finds_its_files():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "adapters" / f"{mix['adapter']}.py").is_file()
        limits = json.loads((HERE / "cells" / f"{w['name']}.json").read_text())
        assert set(limits) == {"mean_gap"} and limits["mean_gap"] > 0
        assert 0 < mix["check"]["min_tokens"] <= mix["check"]["sample_tokens"]
    # no traffic mix or limits file that no cell names
    assert {f.stem for f in (HERE / "traffic").glob("*.json")} == {
        w["traffic"] for w in BENCH["workloads"]}
    assert {f.stem for f in (HERE / "cells").glob("*.json")} == set(CELLS)
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert BENCH["end_to_end"][-1]["name"] == "setup_s"


def test_every_cell_reports_setup_an_end_to_end_and_a_layer():
    for w in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w in m.get("workloads", CELLS)]
        layer = [m for m in BENCH["per_layer"] if w in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("mix_name", ["chat", "batch_decode_long"])
def test_traffic_is_a_function_of_the_seed(mix_name):
    mix = CHAT_MIX if mix_name == "chat" else json.loads(
        (HERE / "traffic" / f"{mix_name}.json").read_text())
    if mix["adapter"] == "paged_decoder":
        a, b = (gen.batch_prompts(mix, 2**31 + 5, 32000) for _ in range(2))
        assert np.array_equal(a, b)
        assert not np.array_equal(a, gen.batch_prompts(mix, 2**31 + 6, 32000))
        return

    def turns(seed):
        clients = gen.chat_clients(mix, seed, 32000)
        out = []
        for c in clients[:4]:
            for _ in range(12):
                rid, prompt, new = c.next_request()
                out.append((rid, tuple(prompt), new))
                c.answered([7] * new)
        return out

    assert turns(2**31 + 5) == turns(2**31 + 5)
    assert turns(2**31 + 5) != turns(2**31 + 6)


def test_every_seed_draws_the_same_sizes():
    """The same set of sizes for every seed, in the seed's own order."""
    mix = dict(CHAT_MIX, new_tokens={"median": 96, "sigma": 0.6, "min": 32,
                                     "max": 256})
    news, users = [], []
    for seed in (1, 2**31 + 9):
        c = gen.chat_clients(mix, seed, 32000)[0]
        news.append(c._news)
        users.append(c._users)
    assert sorted(news[0]) == sorted(news[1]) and news[0] != news[1]
    assert sorted(users[0]) == sorted(users[1]) and users[0] != users[1]
    pool = gen.quantile_pool(mix["new_tokens"])
    assert sorted(pool) == sorted(news[0])
    assert min(pool) >= 32 and max(pool) <= 256
    assert abs(statistics.median(pool) - 96) <= 2


def test_conversations_keep_to_their_turns_and_context():
    mix = CHAT_MIX
    c = gen.chat_clients(mix, 3, 32000)[1]
    for _ in range(200):
        rid, prompt, new = c.next_request()
        assert c.turn <= mix["max_turns"]
        assert len(prompt) + new <= mix["max_context"]
        assert prompt[:mix["system_tokens"]] == c.system
        c.answered(list(range(new)))


def test_percentiles_take_every_sample():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 90) is None
    assert stats.percentile(list(reversed(v)) + [1000], 95) == 96
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)


def test_flops_count_the_window():
    d = {"dim": 4, "heads": 2, "kv_heads": 1, "head_dim": 2, "ffn": 8,
         "vocab": 10, "layers": 3, "experts": None, "top_k": None,
         "window": None}
    fixed, per_key = yardstick.token_flops(d)
    assert fixed == 3 * (2 * 4 * 4 + 4 * 4 * 2 + 2 * 4 * 4 + 6 * 4 * 8) + 2 * 4 * 10
    assert yardstick.flops(d, [(0, 3)]) == 3 * fixed + per_key * (1 + 2 + 3)
    d["window"] = 2
    assert yardstick.flops(d, [(0, 4)]) == 4 * fixed + per_key * (1 + 2 + 2 + 2)
    moe = dict(d, experts=8, top_k=2)
    assert yardstick.token_flops(moe)[0] - fixed == 3 * (2 * 4 * 8 + 6 * 4 * 8)


@pytest.mark.parametrize("workload", REHEARSED)
def test_reference_holds_the_port_through_the_adapters(workload):
    out = run_tiny(workload)
    assert out["checks"]["mean_gap"]["value"] < 1e-4
    assert out["checks"]["tokens_checked"]["value"] >= mix_of(workload)["check"]["min_tokens"]
    assert out["checks"]["short_answers"]["value"] == 0


@pytest.mark.parametrize("workload", REHEARSED)
def test_the_last_line_has_the_contract_keys(workload):
    out = run_tiny(workload)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in spec_of(workload)["end_to_end"]}
    assert set(out["metrics"]) == want
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    json.dumps(out)


CARD_PATH = """
import sys
sys.path.insert(0, {root!r})
from e2ebench import run, calibrate, check, devtrace, gen, stats, weights, yardstick
from e2ebench.reference import decoder
from e2ebench.adapters import serving_engine, paged_decoder
import importlib, json
for m in json.load(open({bench!r}))["per_layer"]:
    importlib.import_module("e2ebench.metrics." + m["name"])
from e2ebench.tests.tiny import CHAT, run_tiny
for w in [c["name"] for c in json.load(open({bench!r}))["workloads"]] + [CHAT]:
    run_tiny(w, seconds=0.4)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
from e2ebench.reference import decoder
from e2ebench import check
print(__import__("json").dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           bench=str(ROOT / "BENCHMARK.json"))],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_card_path_loads_no_jax():
    names = _top_level(CARD_PATH)
    assert "oncilla_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "oncilla_tpu"}


def test_the_reference_loads_nothing_of_the_system():
    names = _top_level(REFERENCE_ONLY)
    assert not names & {"jax", "jaxlib", "flax", "oncilla_tpu",
                        "oncilla_tpu_torch"}


def test_the_check_is_named_by_whole_top_level_names():
    from e2ebench import run

    saved = dict(sys.modules)
    try:
        sys.modules["oncilla_tpu_torch_fake"] = sys
        assert "oncilla_tpu" not in run.loaded_forbidden()
        sys.modules["oncilla_tpu.x"] = sys
        assert "oncilla_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_card_no_result(capsys):
    from e2ebench import run

    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", REHEARSED)
def test_a_traced_run_on_the_cpu_reports_no_device_metric(workload):
    out = run_tiny(workload, trace=True)
    assert out["metrics"] == {} and out["correct"] is True
    assert out["device"]["platform"] == "cpu" and out["device"]["busy_s"] == 0
