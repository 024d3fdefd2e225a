"""The port's chaos harness (``oncilla_tpu_torch/resilience/chaos.py``) and
its black box, run where the JAX package runs its own: on the port's pool
seam, client and daemons.

Sources, each test named below imported and collected here as a case:

- ``tests/test_resilience.py``: the three chaos-harness tests, with the
  port's ``ChaosController``, ``ChaosSchedule`` and ``Fault`` under the
  names the source bound, and the port's client and daemons in place
  (``test_torch_mux.use_port_client``): every lease the replay test counts
  goes through the port's pool, where the port's controller is installed.
- ``tests/test_native_obs.py::test_mixed_cluster_chaos_kill_audited``: a
  port Python daemon (rank 0, in process) and the port's copy of the native
  daemon (rank 1, ``OCM_FLIGHTREC`` armed, built by
  ``runtime/cluster.build_daemon`` and started by the ``native`` shim
  below), the native rank killed mid-put; the port's recorder and auditor
  (``flightrec``, ``audit``) merge the native segments with the Python
  rank's and find nothing.

Nothing in ``oncilla_tpu/`` or the JAX tests changes.

Added here: the port's schedules equal the JAX package's for the same
seeds, and ``corrupt_file`` flips the same byte.
"""

import os
import subprocess

import numpy as np
import pytest

import test_native_obs as src_native_obs
import test_resilience as src_resilience
from oncilla_tpu.resilience import chaos as jchaos
from oncilla_tpu_torch.analysis import alloctrace as talloctrace
from oncilla_tpu_torch.obs import audit as taudit
from oncilla_tpu_torch.obs import flightrec as tflightrec
from oncilla_tpu_torch.resilience import chaos as tchaos
from oncilla_tpu_torch.runtime import cluster as tcluster
from oncilla_tpu_torch.runtime import snapshot as tsnap
from test_torch_daemon import export_ref, patch_ref
from test_torch_mux import use_port_client

RUN_RESILIENCE = [
    "test_chaos_schedule_deterministic",
    "test_chaos_replay_identical_interleaving",
    "test_chaos_partition_blocks_and_heals",
]

RUN_NATIVE_OBS = [
    "test_mixed_cluster_chaos_kill_audited",
]

export_ref(globals(), src_resilience, RUN_RESILIENCE)
export_ref(globals(), src_native_obs, RUN_NATIVE_OBS)


class PortNative:
    """The JAX ``runtime.native.native`` module's ``build``/``spawn``,
    starting the port's copy of the native daemon."""

    @staticmethod
    def build():
        return tcluster.build_daemon()

    @staticmethod
    def spawn(nodefile: str, rank: int, *, policy: str = "capacity",
              ndevices: int = 1, host_arena_bytes=None,
              device_arena_bytes=None, lease_s=None, heartbeat_s=None,
              env=None, binary=None):
        cmd = [str(binary or tcluster.build_daemon()), "--nodefile", nodefile,
               "--rank", str(rank), "--policy", policy,
               "--ndevices", str(ndevices)]
        for flag, value in (("--host-arena-bytes", host_arena_bytes),
                            ("--device-arena-bytes", device_arena_bytes),
                            ("--lease-s", lease_s),
                            ("--heartbeat-s", heartbeat_s)):
            if value is not None:
                cmd += [flag, str(value)]
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.STDOUT,
                                stdin=subprocess.DEVNULL,
                                env={**os.environ, **(env or {})})


@pytest.fixture(scope="module")
def binary():
    """The port's copy of the native daemon (a missing compiler raises)."""
    return tcluster.build_daemon()


_PORT_CHAOS = {"ChaosController": tchaos.ChaosController,
               "ChaosSchedule": tchaos.ChaosSchedule, "Fault": tchaos.Fault,
               "corrupt_file": tchaos.corrupt_file}


@pytest.fixture(autouse=True)
def _port_harness(request, monkeypatch):
    module = request.function.__module__
    if module == src_resilience.__name__:
        use_port_client(monkeypatch, src_resilience, alloctrace=talloctrace,
                        snap=tsnap, **_PORT_CHAOS)
    elif module == src_native_obs.__name__:
        patch_ref(monkeypatch, src_native_obs, native=PortNative,
                  flightrec=tflightrec, audit=taudit)


@pytest.mark.parametrize("seed", [0, 7, 99])
def test_schedules_equal_jax(seed):
    acts = ("drop", "delay", "partition", "heal", "kill", "restart")
    for kw in ({}, {"nfaults": 6, "actions": acts},
               {"nfaults": 3, "span": 10, "protect": (0, 1)}):
        got = tchaos.ChaosSchedule.generate(seed, nranks=4, **kw)
        want = jchaos.ChaosSchedule.generate(seed, nranks=4, **kw)
        assert [vars(f) for f in got.faults] == [vars(f) for f in want.faults]
    got = tchaos.ChaosSchedule.kill_at(seed, 2, 5, extra=(
        tchaos.Fault(op=3, action="restart", rank=1),))
    assert [(f.op, f.action, f.rank) for f in got.faults] == [
        (3, "restart", 1), (5, "kill", 2)]
    assert tchaos.ACTIONS == jchaos.ACTIONS


def test_corrupt_file_flips_the_jax_byte(tmp_path):
    data = np.random.default_rng(3).integers(0, 256, 777, dtype=np.uint8)
    for seed in (0, 1, 2):
        a, b = tmp_path / f"a{seed}", tmp_path / f"b{seed}"
        a.write_bytes(data.tobytes())
        b.write_bytes(data.tobytes())
        assert tchaos.corrupt_file(str(a), seed=seed) == \
            jchaos.corrupt_file(str(b), seed=seed)
        assert a.read_bytes() == b.read_bytes() != data.tobytes()
