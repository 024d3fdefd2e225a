"""The port's GUPS (``oncilla_tpu_torch.benchmarks.gups``) on the CPU: the
JAX package's five GUPS cases (tests/test_benchmarks.py) re-run on the
port, with the mesh flavor on four CPU rows; the port's table against
``np.bincount`` of its own indices for both methods; the update and
table-sum counts of each flavor equal to the JAX package's at the same
arguments (the two packages draw other indices, so they agree on the
invariant, not on the table); and the CLI, which refuses without CUDA
unless told ``--device cpu``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oncilla_tpu.benchmarks import gups as jgups
from oncilla_tpu_torch.benchmarks import gups
from oncilla_tpu_torch.core.errors import OcmDeviceError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU4 = ["cpu"] * 4


def test_gups_single_conserves_updates():
    out = gups.gups_single(words=1 << 12, batch=256, steps=8, seed=3, device="cpu")
    assert out["table_sum"] == out["updates"] == 8 * 256
    assert out["gups"] > 0


def test_gups_mesh_conserves_updates():
    out = gups.gups_mesh(CPU4, words_per_dev=1 << 10, batch=64, steps=4, seed=3)
    d = 4
    per_dest = 64 // d
    assert out["mode"] == "mesh:4dev"
    assert out["updates"] == 4 * d * d * per_dest
    assert out["table_sum"] == out["updates"]
    assert out["gups"] > 0


def test_gups_methods_agree_and_conserve():
    for method in gups.METHODS:
        out = gups.gups_single(words=1 << 10, batch=256, steps=4, method=method,
                               device="cpu")
        assert out["table_sum"] == out["updates"] == 1024, out
    best = gups.gups_single_best(words=1 << 10, batch=256, steps=4, device="cpu")
    assert best["table_sum"] == best["updates"]
    assert best["mode"] in ("single:scatter", "single:bincount")


def test_gups_handles_conserves_through_handle():
    """The handle flavor: updates land inside an OcmAlloc extent of the
    plane's row, and the conservation read-back goes through the handle."""
    for method in gups.METHODS:
        out = gups.gups_handles(words=1 << 10, batch=256, steps=4, method=method,
                                device="cpu")
        assert out["table_sum"] == out["updates"] == 4 * 256
        assert out["gups"] > 0
    best = gups.gups_handle_best(words=1 << 10, batch=256, steps=4, device="cpu")
    assert best["mode"].startswith("handle:")
    assert best["table_sum"] == best["updates"]


def test_gups_handles_multidevice_plane_rows_untouched():
    """On a multi-device plane only the handle's row changes: the other rows
    keep their bytes and the conservation count stays exact."""
    from oncilla_tpu_torch.ops.ici import SpmdIciPlane
    from oncilla_tpu_torch.parallel import spmd_arena as sa
    from oncilla_tpu_torch.utils.config import OcmConfig

    plane = SpmdIciPlane(config=OcmConfig(device_arena_bytes=1 << 20),
                         mesh=CPU4, devices_per_rank=4)
    stamps = {}
    for d in range(1, 4):
        stamps[d] = torch.full((64,), d, dtype=torch.uint8)
        plane.update(lambda a, d=d, s=stamps[d]: sa.host_put(a, d, s, 4096))
    out = gups.gups_handles(words=1 << 8, batch=128, steps=2, plane=plane)
    assert out["table_sum"] == out["updates"] == 2 * 128
    for d in range(1, 4):
        assert torch.equal(sa.host_get(plane.arena, d, 64, 4096), stamps[d])


@pytest.mark.parametrize("method", gups.METHODS)
def test_table_equals_bincount_of_its_own_indices(method):
    words, batch, steps, seed = 1 << 9, 300, 5, 11
    table = torch.zeros(words, dtype=torch.int32)
    gups._run(table, steps, batch, seed, method)
    gen = torch.Generator()
    drawn = np.concatenate([
        gups._indices(gen, seed, i, (batch,), words, "cpu").numpy()
        for i in range(steps)])
    want = np.bincount(drawn, minlength=words).astype(np.uint32)
    np.testing.assert_array_equal(table.view(torch.uint32).numpy(), want)


@pytest.mark.parametrize("flavor", ["single", "handle", "mesh"])
def test_counts_equal_the_jax_package(flavor):
    kw = {"words": 1 << 10, "batch": 256, "steps": 4, "seed": 5}
    if flavor == "single":
        got = gups.gups_single(device="cpu", **kw)
        want = jgups.gups_single(**kw)
    elif flavor == "handle":
        got = gups.gups_handle_best(device="cpu", **kw)
        want = jgups.gups_handle_best(**kw)
    else:
        from oncilla_tpu.parallel.mesh import node_mesh

        mesh = node_mesh()
        ndev = int(mesh.devices.size)
        mkw = {"words_per_dev": 1 << 10, "batch": 64, "steps": 4, "seed": 5}
        got = gups.gups_mesh(["cpu"] * ndev, **mkw)
        want = jgups.gups_mesh(mesh, **mkw)
    assert set(got) == set(want)
    assert got["mode"].split(":")[0] == want["mode"].split(":")[0]
    assert got["updates"] == want["updates"] == got["table_sum"] == want["table_sum"]


def test_cli_refuses_without_cuda_and_runs_on_the_cpu_when_told(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("single", "mesh"):
        with pytest.raises(OcmDeviceError):
            gups.main(["--mode", mode, "--words", "1024", "--batch", "64",
                       "--steps", "2"])
    assert capsys.readouterr().out == ""
    env = dict(os.environ, PYTHONPATH=REPO)
    for mode in ("single", "mesh"):
        r = subprocess.run(
            [sys.executable, "-m", "oncilla_tpu_torch.benchmarks.gups", "--mode",
             mode, "--words", "1024", "--batch", "64", "--steps", "2",
             "--device", "cpu"], capture_output=True, text=True, timeout=120,
            env=env)
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout)
        assert out["table_sum"] == out["updates"]


def test_benchmarks_exports_the_jax_names():
    import oncilla_tpu.benchmarks as jb
    import oncilla_tpu_torch.benchmarks as pb

    assert pb.__all__ == sorted(jb.__all__)
    for name in pb.__all__:
        assert getattr(pb, name).__name__ == getattr(jb, name).__name__
    assert pb.gups_single is gups.gups_single and pb.gups_mesh is gups.gups_mesh
