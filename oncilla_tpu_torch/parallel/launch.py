"""Start N processes that form one ``torch.distributed`` world.

:func:`spawn` runs ``module:function`` in ``nprocs`` fresh Python
processes, rank r on card r (NCCL) or on the CPU (gloo, only when the
caller asks for it), with a ``file://`` rendezvous in a directory of its
own, so concurrent spawns never race for a port. It waits for every child
with a deadline, kills the whole group on expiry or on the first failure,
and raises with each failed child's traceback; it returns the children's
results in rank order. :func:`init_from_env` joins the world ``torchrun``
describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``).

Run as ``python -m oncilla_tpu_torch.parallel.launch SPEC RANK``: the child
side, which reads the pickled spec :func:`spawn` wrote.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from oncilla_tpu_torch.core.errors import OcmDeviceError


class SpawnError(RuntimeError):
    """A child failed or the group ran past its deadline; the message holds
    every failed child's traceback and the tail of its output."""


def _resolve(target: str):
    mod, _, name = target.partition(":")
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _backend(device: str) -> str:
    if device == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise OcmDeviceError("CUDA is not available; pass device='cpu' to spawn "
                             "gloo processes on the CPU")
    return "nccl"


def spawn(target: str, nprocs: int, *, args=(), kwargs=None, device: str = "cuda",
          timeout: float = 120.0) -> list:
    """Run ``target`` (``"module:function"``) as ``function(*args,
    **kwargs)`` in ``nprocs`` processes of one world and return their
    results (picklable) by rank. ``device`` "cuda" puts rank r on card
    ``r % device_count`` under NCCL; "cpu" uses gloo. Each child runs one
    intra-op thread (the processes share the host's cores). A child that
    raises, or a group that runs past ``timeout`` seconds, kills every
    child and raises :class:`SpawnError`."""
    backend = _backend(device)
    tmp = tempfile.mkdtemp(prefix="ocm_spawn_")
    spec = os.path.join(tmp, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"target": target, "args": tuple(args),
                     "kwargs": dict(kwargs or {}), "world": nprocs,
                     "backend": backend, "device": device, "timeout": timeout,
                     "init": "file://" + os.path.join(tmp, "rendezvous")}, f)
    child_env = dict(os.environ, OMP_NUM_THREADS="1")
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.getcwd(), *sys.path] if p)
    procs, logs = [], []
    try:
        for r in range(nprocs):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "oncilla_tpu_torch.parallel.launch", spec,
                 str(r)], stdout=log, stderr=subprocess.STDOUT, env=child_env,
                start_new_session=True))
        failed = _wait(procs, time.monotonic() + timeout)
        results = []
        for r in range(nprocs):
            path = os.path.join(tmp, f"rank{r}.out")
            status, payload = ("missing", None)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    status, payload = pickle.load(f)
            if status != "ok" and r not in failed:
                failed[r] = procs[r].returncode
            results.append(payload)
        if failed:
            raise SpawnError(_report(target, failed, tmp, logs))
        return results
    finally:
        for p in procs:
            _kill(p)
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _wait(procs, deadline: float) -> dict:
    """Wait for every child; on the first failure give the rest a few
    seconds (they may be blocked in a collective with it), then kill.
    Returns {rank: exit code or "timeout"} of the children that failed."""
    failed: dict = {}
    while True:
        codes = [p.poll() for p in procs]
        for r, c in enumerate(codes):
            if c not in (None, 0):
                failed[r] = c
        if all(c is not None for c in codes):
            return failed
        now = time.monotonic()
        if failed:
            deadline = min(deadline, now + 5.0)
        if now > deadline:
            for r, c in enumerate(codes):
                if c is None:
                    failed[r] = "timeout"
            return failed
        time.sleep(0.05)


def _kill(p) -> None:
    if p.poll() is None:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    p.wait()


def _report(target: str, failed: dict, tmp: str, logs) -> str:
    lines = [f"spawn of {target}: ranks {sorted(failed)} failed "
             f"({failed})"]
    for r in sorted(failed):
        path = os.path.join(tmp, f"rank{r}.out")
        if os.path.exists(path):
            with open(path, "rb") as f:
                status, payload = pickle.load(f)
            if status == "error":
                lines.append(f"--- rank {r} traceback:\n{payload}")
        logs[r].flush()
        logs[r].seek(0)
        lines.append(f"--- rank {r} output (tail):\n{logs[r].read()[-6000:]}")
    return "\n".join(lines)


def init_from_env(device: str = "cuda") -> tuple[int, int]:
    """Join the world ``torchrun`` (or :func:`spawn`) describes in the
    environment: NCCL on card ``LOCAL_RANK`` for "cuda", gloo for "cpu".
    Returns (rank, world size); a process with no such environment is a
    world of one and joins nothing."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    return rank, world


def _child(spec_path: str, rank: int) -> int:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = os.path.join(os.path.dirname(spec_path), f"rank{rank}.out")
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(spec["world"]),
                      LOCAL_RANK=str(rank))
    try:
        if spec["backend"] == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            spec["backend"], init_method=spec["init"], rank=rank,
            world_size=spec["world"],
            timeout=datetime.timedelta(seconds=spec["timeout"]))
        result = _resolve(spec["target"])(*spec["args"], **spec["kwargs"])
        status, payload = "ok", result
    except BaseException:
        status, payload = "error", traceback.format_exc()
    with open(out, "wb") as f:
        pickle.dump((status, payload), f)
    if status == "ok" and dist.is_initialized():
        dist.destroy_process_group()
    return 0 if status == "ok" else 1


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
