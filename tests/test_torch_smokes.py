"""The port's operator smokes: ``python -m oncilla_tpu_torch.{obs,
resilience,elastic,qos,fabric}``.

- ``obs --smoke``, ``obs slo --selftest``, ``elastic --smoke``, ``qos
  --smoke`` and ``fabric --smoke`` in process, as their CLIs run them
  (each exits 0), and all but the selftest as processes too.
- ``resilience --smoke``, ``--leader-smoke`` and ``--deadline-smoke`` as
  processes (see ``test_resilience_smoke_as_a_process``), all on seed 1234.
- The seeded chaos runs equal the JAX package's on the same seed: the
  kill-the-owner scenario's schedule, fault interleaving and failover
  outcome (the fields the JAX smoke's own replay check compares). The
  port's copy of the scenario waits for the re-replication to finish
  before it reads the new replica's bytes; the JAX one does not (ROADMAP
  Queue C).

Each runs once: a failure fails the test.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from oncilla_tpu.resilience import __main__ as jres_main
from oncilla_tpu_torch.elastic import __main__ as telastic_main
from oncilla_tpu_torch.fabric import __main__ as tfabric_main
from oncilla_tpu_torch.obs import __main__ as tobs_main
from oncilla_tpu_torch.qos import __main__ as tqos_main
from oncilla_tpu_torch.resilience import __main__ as tres_main

ROOT = Path(__file__).resolve().parents[1]

IN_PROCESS = {
    "obs --smoke": lambda: tobs_main.main(["--smoke"]),
    "obs slo --selftest": lambda: tobs_main.main(["slo", "--selftest"]),
    "elastic --smoke": lambda: telastic_main.main(["--smoke"]),
    "qos --smoke": lambda: tqos_main.main(["--smoke"]),
    "fabric --smoke": lambda: tfabric_main.main(["--smoke"]),
}


@pytest.mark.parametrize("name", sorted(IN_PROCESS))
def test_smoke_in_process(name, capsys):
    assert IN_PROCESS[name]() == 0
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ["obs", "--smoke"], ["elastic", "--smoke"], ["qos", "--smoke"],
    ["fabric", "--smoke"],
])
def test_module_entry_as_a_process(args):
    r = subprocess.run(
        [sys.executable, "-m", f"oncilla_tpu_torch.{args[0]}", *args[1:]],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "OK" in r.stdout.splitlines()[-1]


def _run_raised(argv: list[str]) -> tuple[int, str, str]:
    """``argv`` as a process, reniced ahead of the suite's other workers
    right after it starts, where the host allows it (threads it starts
    later inherit the value); otherwise as the host schedules it."""
    p = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        os.setpriority(os.PRIO_PROCESS, p.pid, -10)
    except OSError:
        pass
    try:
        out, err = p.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
    return p.returncode, out, err


@pytest.mark.parametrize("flag", ["--smoke", "--leader-smoke",
                                  "--deadline-smoke"])
def test_resilience_smoke_as_a_process(flag):
    """The control plane's chaos smokes, each in a fresh process as its
    users run it. They run 50 ms failure detectors and count background
    probes among the ops their faults fire at, so a host the suite's other
    workers load can starve them (ROADMAP Queue C; in-process repeats fail
    more, the earlier smokes' threads adding probes). So each runs at a
    raised scheduling priority where the host allows it."""
    rc, out, err = _run_raised(
        [sys.executable, "-m", "oncilla_tpu_torch.resilience", flag])
    last = (out.strip().splitlines() or [""])[-1]
    assert rc == 0 and " OK" in last, (
        f"resilience {flag} exited {rc}:\n{out[-3000:]}{err[-3000:]}")


def test_qos_storm_draws_back_pressure_on_a_slow_host(monkeypatch):
    """The soak's pressure storm on a host whose allocs are slow against
    the reapers' 0.2 s ticks (2 ms a hog's alloc, as an H100 machine's host
    nearly was): it runs past its handle cap until back-pressure has fired
    (ROADMAP Queue C), and every contract after it holds."""
    from oncilla_tpu_torch.runtime.client import ControlPlaneClient

    real = ControlPlaneClient.alloc

    def slow_alloc(self, nbytes, *a, **kw):
        if nbytes == 1 << 20:
            time.sleep(0.002)
        return real(self, nbytes, *a, **kw)

    monkeypatch.setattr(ControlPlaneClient, "alloc", slow_alloc)
    out = tqos_main.run_soak(1234, 6, 3, True)
    assert out["busy_total"] > 0 and out["evicted_low"] > 0


def test_usage_without_a_mode():
    assert tres_main.main([]) == 2
    assert tfabric_main.main([]) == 2


def test_kill_owner_scenario_equals_jax():
    want = jres_main.run_scenario(1234)
    got = tres_main.run_scenario(1234)
    assert [vars(f) for f in got["schedule"].faults] == \
        [vars(f) for f in want["schedule"].faults]
    assert got["log"] == want["log"] == [
        (2, "drop", -1), (4, "kill", 1), (7, "delay", -1)]
    assert (got["owner"], got["promoted"]) == (want["owner"], want["promoted"])

