"""The port's multi-process entry points on the CPU (gloo), as the JAX
package's ``test_multihost.py`` runs its walkthrough.

``oncilla_tpu_torch/examples/multihost_train.py`` with 2 processes (spawned
by ``--nprocs``, then under ``torchrun --standalone``): membership from the
process group, one port daemon a process, the sharded dense step over one
(1, 2, 1) mesh of both (losses identical and falling in each), and the
parameters checkpointed by process 0 into a REMOTE_HOST allocation that the
daemons place in rank 1's arena, read back byte for byte by every process,
whose own shards ``load_sharded`` restores bit for bit.
``examples/train_parallel.py``'s four families with 4 processes.
"""

import os
import pathlib
import re
import signal
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(argv, timeout=240):
    p = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, cwd=REPO, start_new_session=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        raise AssertionError(f"{argv} timed out:\n{out[-3000:]}")
    assert p.returncode == 0, out[-3000:]
    return out


def _check_walkthrough(out):
    assert "multihost walkthrough ok" in out, out[-3000:]
    assert out.count("checkpoint of") == 2, out[-3000:]
    assert out.count("restored bit for bit by load_sharded") == 2, out[-3000:]
    assert "mesh={'dp': 1, 'tp': 2, 'sp': 1}" in out, out[-3000:]
    losses = re.findall(r"losses=(\[.*?\])", out)
    assert len(losses) == 2 and losses[0] == losses[1], losses


def test_two_process_mesh_train_and_ocm_checkpoint():
    _check_walkthrough(_run([sys.executable, "-m",
                             "oncilla_tpu_torch.examples.multihost_train",
                             "--nprocs", "2", "--device", "cpu"]))


def test_the_walkthrough_under_torchrun():
    torchrun = pathlib.Path(sys.executable).with_name("torchrun")
    if not torchrun.exists():
        pytest.fail(f"torchrun is not beside {sys.executable}")
    _check_walkthrough(_run([str(torchrun), "--standalone", "--nproc-per-node", "2",
                             "-m", "oncilla_tpu_torch.examples.multihost_train",
                             "--device", "cpu"]))


def test_train_parallel_trains_four_ways():
    out = _run([sys.executable, "-m", "oncilla_tpu_torch.examples.train_parallel",
                "--nprocs", "4", "--device", "cpu"])
    assert "all four parallelism modes trained" in out, out
    for name, mesh in (("dense", "{'dp': 1, 'tp': 2, 'sp': 2}"),
                       ("moe", "{'dp': 1, 'ep': 2, 'tp': 2}"),
                       ("gpipe", "{'dp': 1, 'pp': 4}"),
                       ("moe-pp", "{'dp': 2, 'pp': 2}")):
        assert re.search(rf"{name}\s+mesh={re.escape(mesh)} loss", out), out


def test_phase_t_on_the_cpu():
    """``chip_smoke.phase_train_mesh`` (``--across-cards`` phase T) at a
    tiny size in 4 gloo processes: the four families' falling losses and
    collective bytes, each family against the one-device step, the MoE
    state resumed on another mesh bit for bit, the walkthrough."""
    import chip_smoke

    rep = chip_smoke.phase_train_mesh(4, device="cpu", timeout=240)
    for name in ("dense", "moe", "gpipe", "moe_pp"):
        assert rep[name]["losses"][-1] < rep[name]["losses"][0]
        assert rep[name]["collective_bytes_per_step"]
    assert rep["dense"]["collective_bytes_per_step"].get("sp send", 0) > 0
    assert rep["moe"]["collective_bytes_per_step"].get("ep all_reduce", 0) > 0
    assert set(rep["one_card"]) == {"dense", "gpipe", "moe_pp", "moe"}
    assert rep["resume"]["bit_for_bit"]
    assert rep["resume"]["new_mesh"] == {"dp": 1, "ep": 2, "tp": 2}
    assert any("restored bit for bit" in line for line in rep["multihost"])
