"""The port's wire legs (``oncilla_tpu_torch.benchmarks.dcn``) on the CPU,
against the port's own daemons: the JAX package's two
``dcn_loopback_bench`` cases (tests/test_benchmarks.py), the stripe, fabric
and daemon sweeps at 8 MiB with the JAX sweeps' cell keys and units (the
JAX functions run on stand-in daemons that answer every round trip, so
only their structure is compared), the mux and hedge sweeps, ``smoke``,
``native_smoke`` and the CLI as a process. The legs carry host buffers
only: no test here needs a card."""

import contextlib
import json
import os
import subprocess
import sys

import pytest

from oncilla_tpu.benchmarks import dcn as jdcn
from oncilla_tpu_torch.benchmarks import dcn

MiB = 1 << 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape(x):
    """Nested keys, with every leaf replaced by its type (ints and floats
    alike), so two results compare by structure."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, bool):
        return bool
    if isinstance(x, (int, float)):
        return float
    return type(x)


@pytest.fixture()
def jax_stand_in(monkeypatch):
    """The JAX sweeps with their daemons replaced by a stand-in: each round
    trip answers a fixed verified cell."""

    @contextlib.contextmanager
    def pair(cfg, native, extra_env=None):
        yield []

    def roundtrip(entries, cfg, nbytes, iters, data):
        return {"put_gbps": 1.0, "get_gbps": 2.0, "unit": "Gbit/s",
                "verified": True}

    monkeypatch.setattr(jdcn, "_daemon_pair", pair)
    monkeypatch.setattr(jdcn, "_timed_roundtrip", roundtrip)
    return jdcn


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_dcn_loopback_bench_measures_and_verifies(native):
    """test_benchmarks.py's two cases on the port: daemon-path put/get
    through two daemon processes (the port's Python daemon, or its copy of
    the native one), roundtrip-verified, in Gbit/s."""
    r = dcn.dcn_loopback_bench(nbytes=8 * MiB, iters=2, native=native)
    assert r["verified"] and r["native_daemons"] is native
    assert r["put_gbps"] > 0 and r["get_gbps"] > 0
    assert r["nbytes"] == 8 * MiB and r["unit"] == "Gbit/s"
    assert set(r) == {"put_gbps", "get_gbps", "unit", "verified", "nbytes",
                      "iters", "native_daemons", "stripes"}


@pytest.mark.parametrize("sweep,kw", [
    ("dcn_stripe_sweep", {"nbytes": 8 * MiB, "iters": 1}),
    ("dcn_fabric_sweep", {"sizes": (8 * MiB,), "iters": 1}),
    ("dcn_daemon_sweep", {"nbytes": 8 * MiB, "iters": 1}),
])
def test_sweeps_have_the_jax_cells_and_units(sweep, kw, jax_stand_in):
    got = getattr(dcn, sweep)(**kw)
    want = getattr(jax_stand_in, sweep)(**kw)
    assert got["verified"] is True and got["unit"] == "Gbit/s"
    assert _shape(got) == _shape(want)
    assert list(got["cells"]) == list(want["cells"])
    assert all(c["verified"] for c in got["cells"].values())
    if sweep == "dcn_stripe_sweep":
        assert got["native_daemons"] is True  # the native daemon builds here
        assert got["best"] in got["cells"]


def test_mux_smoke_holds_its_contracts():
    """``--mux --smoke``: byte-exact tenants and large cells, and the mux
    fleet on at most one socket a peer."""
    r = dcn.dcn_mux_sweep(smoke=True)
    assert r["verified"] and r["mux"]["sockets"] <= 3
    assert r["lockstep"]["threads"] == 8 and r["mux"]["threads"] == 1
    assert r["large"]["mux"]["unit"] == "Gbit/s"


def test_hedge_sweep_cuts_the_tail():
    # A 200 ms stall against a 5 ms hedge: the sweep's own p99 assertion
    # keeps its meaning on a loaded host.
    r = dcn.dcn_hedge_sweep(rounds=12, delay_ms=200.0)
    assert r["verified"] is True
    assert r["hedged"]["p99_ms"] < r["unhedged"]["p99_ms"]
    assert r["unhedged"]["p50_ms"] >= 200.0


def test_smoke_rides_both_protocols_and_shm():
    r = dcn.smoke(4 * MiB)
    assert r["verified"] is True
    assert set(r) == {"tcp_stripes4_roundtrip_s", "tcp_stripes1_roundtrip_s",
                      "shm_stripes1_roundtrip_s", "verified"}


def test_native_smoke_is_coalesced_and_striped():
    """The Python client against the native daemon's copy: COALESCE granted,
    the put striped four ways, the get byte-exact."""
    r = dcn.native_smoke(32 * MiB)
    assert r["verified"] and r["coalesce_granted"] and r["stripes"] == 4
    assert r["unit"] == "Gbit/s"


def test_cli_smoke_as_a_process():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "oncilla_tpu_torch.benchmarks.dcn", "--smoke"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout)["verified"] is True
