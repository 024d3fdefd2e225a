"""The port's arena and context held against the JAX package on the CPU.

- One seeded sequence of alloc / write / read / move / fill_zero / free runs
  against the JAX ``DeviceArena`` and the port's (``device="cpu"``); after
  every op the extents, the whole arena's bytes and the error types agree.
- The ocm_test-shaped cases of tests/test_local_context.py run on both
  packages and must give the same bytes, offsets and errors.
- The port imports neither ``jax`` nor ``oncilla_tpu``, and its entry points
  raise without CUDA unless asked for the CPU.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
from oncilla_tpu.core.hbm import DeviceArena as JaxArena
from oncilla_tpu_torch.core.hbm import DeviceArena as TorchArena

ROOT = Path(__file__).resolve().parents[1]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- seeded arena op sequence -------------------------------------------------


def _apply(arena, op):
    """Run one op; returns ("ok", result) or ("err", exception class name)."""
    kind, args = op[0], op[1:]
    try:
        if kind == "alloc":
            e = arena.alloc(args[0])
            return "ok", (e.offset, e.nbytes)
        if kind == "write":
            ext, data, off = args
            arena.write(ext, data, off)
            return "ok", None
        if kind == "read":
            ext, n, off = args
            return "ok", _np(arena.read(ext, n, off)).tobytes()
        if kind == "move":
            src, dst, n, so, do = args
            arena.move(src, dst, n, so, do)
            return "ok", None
        if kind == "fill":
            ext, n, off = args
            arena.fill_zero(ext, n, off)
            return "ok", None
        if kind == "free":
            arena.free(args[0])
            return "ok", None
    except Exception as e:  # the error TYPE is what the packages must share
        return "err", type(e).__name__
    raise ValueError(kind)


def _as_extent(mod, ext):
    return mod.Extent(ext.offset, ext.nbytes)


def test_arena_op_sequence_matches_jax():
    cap = 256 << 10
    jar = JaxArena(cap, jax.devices()[0], alignment=4096)
    tar = TorchArena(cap, "cpu", alignment=4096)
    rng = np.random.default_rng(7)
    sizes = (512, 4096, 5000, 12288, 40000)
    live: list = []
    freed: list = []
    for step in range(80):
        choice = rng.integers(0, 7) if live else 0
        if choice == 0:
            op = ("alloc", int(rng.choice(sizes + (cap + 1,))))
        elif choice == 1:
            ext = live[rng.integers(len(live))]
            n = int(rng.choice((256, 1024, 4096)))
            off = int(rng.choice((0, 100, max(0, ext.nbytes - n), ext.nbytes - 200)))
            op = ("write", ext, rng.integers(0, 256, n, dtype=np.uint8), off)
        elif choice == 2:
            ext = live[rng.integers(len(live))]
            op = ("read", ext, int(rng.choice((512, 4096))),
                  int(rng.choice((0, 300, ext.nbytes - 100))))
        elif choice == 3:
            a, b = (live[rng.integers(len(live))] for _ in range(2))
            op = ("move", a, b, int(rng.choice((256, 4096))),
                  int(rng.choice((0, 64))), int(rng.choice((0, 128))))
        elif choice == 4:
            ext = live[rng.integers(len(live))]
            op = ("fill", ext, int(rng.choice((100, 512))), int(rng.choice((0, 7))))
        elif choice == 5 and freed:
            op = ("free", freed[rng.integers(len(freed))])  # double free
        else:
            ext = live.pop(rng.integers(len(live)))
            freed.append(ext)
            op = ("free", ext)
        jres = _apply(jar, op)
        tres = _apply(tar, op)
        assert jres == tres, (step, op[0], jres, tres)
        if op[0] == "alloc" and jres[0] == "ok":
            live.append(tocm.Extent(*jres[1]))
        np.testing.assert_array_equal(
            _np(jar.buffer).reshape(-1), _np(tar.buffer), err_msg=f"step {step}"
        )


def test_arena_extents_are_from_separate_but_equal_allocators():
    ja = jocm.ArenaAllocator(1 << 20, 4096)
    ta = tocm.ArenaAllocator(1 << 20, 4096)
    rng = np.random.default_rng(3)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.4:
            j, t = held.pop(rng.integers(len(held)))
            ja.free(j)
            ta.free(t)
        else:
            n = int(rng.integers(1, 70000))
            try:
                j = ja.alloc(n)
            except jocm.OcmOutOfMemory:
                with pytest.raises(tocm.OcmOutOfMemory):
                    ta.alloc(n)
                continue
            t = ta.alloc(n)
            assert (j.offset, j.nbytes) == (t.offset, t.nbytes)
            held.append((j, t))
        assert ja.bytes_free == ta.bytes_free


# -- ocm_test-shaped cases on both packages ---------------------------------


PKGS = {
    "jax": SimpleNamespace(
        mod=jocm, init=lambda cfg: jocm.ocm_init(cfg), f32=np.float32,
    ),
    "torch": SimpleNamespace(
        mod=tocm, init=lambda cfg: tocm.ocm_init(cfg, device="cpu"),
        f32=torch.float32,
    ),
}


def _ctx(pkg):
    m = pkg.mod
    return pkg.init(m.OcmConfig(host_arena_bytes=8 << 20,
                                device_arena_bytes=8 << 20))


def case_lifecycle(pkg, ctx, rng):
    m, out = pkg.mod, []
    for kind in ("LOCAL_HOST", "LOCAL_DEVICE"):
        for _ in range(3):
            h = ctx.alloc(4096, m.OcmKind[kind])
            buf = ctx.localbuf(h)
            out.append((len(buf), m.ocm_is_remote(h), m.ocm_remote_sz(h),
                        m.ocm_alloc_kind(h).value, h.extent.offset))
            ctx.free(h)
            out.append(h.freed)
    return out


def case_put_get(pkg, ctx, rng):
    m, out = pkg.mod, []
    for kind in ("LOCAL_HOST", "LOCAL_DEVICE"):
        h = ctx.alloc(8192, m.OcmKind[kind])
        data = rng.integers(0, 256, 8192, dtype=np.uint8)
        ctx.put(h, data)
        out.append(_np(ctx.get(h, 8192)))
        ctx.put(h, data[:1024], offset=512)
        out.append(_np(ctx.get(h, 1024, offset=512)))
        ctx.free(h)
    return out


def case_bounds(pkg, ctx, rng):
    m, out = pkg.mod, []
    for kind in ("LOCAL_HOST", "LOCAL_DEVICE"):
        h = ctx.alloc(1024, m.OcmKind[kind])
        with pytest.raises(m.OcmBoundsError):
            ctx.put(h, np.zeros(2048, np.uint8))
        with pytest.raises(m.OcmBoundsError):
            ctx.get(h, 100, offset=1000)
        out.append(_np(ctx.get(h)))  # the failed put wrote nothing
        ctx.free(h)
    return out


def case_typed_roundtrip(pkg, ctx, rng):
    m = pkg.mod
    h = ctx.alloc(4 * 256, m.OcmKind.LOCAL_DEVICE)
    ctx.put(h, np.arange(256, dtype=np.float32))
    y = _np(ctx.get_as(h, (256,), pkg.f32))
    ctx.free(h)
    assert y.dtype == np.float32
    return [y]


def case_copy_matrix(pkg, ctx, rng):
    m, out = pkg.mod, []
    kinds = (m.OcmKind.LOCAL_HOST, m.OcmKind.LOCAL_DEVICE)
    for sk in kinds:
        for dk in kinds:
            src, dst = ctx.alloc(2048, sk), ctx.alloc(2048, dk)
            ctx.put(src, rng.integers(0, 256, 2048, dtype=np.uint8))
            ctx.copy(dst, src)
            out.append(_np(ctx.get(dst)))
            ctx.free(src)
            ctx.free(dst)
    return out


def case_copy_offsets(pkg, ctx, rng):
    m = pkg.mod
    src = ctx.alloc(4096, m.OcmKind.LOCAL_DEVICE)
    dst = ctx.alloc(4096, m.OcmKind.LOCAL_DEVICE)
    ctx.put(src, rng.integers(0, 256, 1024, dtype=np.uint8), offset=256)
    ctx.copy(dst, src, nbytes=1024, dst_offset=512, src_offset=256)
    return [_np(ctx.get(dst)), (src.extent.offset, dst.extent.offset)]


def case_use_after_free(pkg, ctx, rng):
    m = pkg.mod
    for kind in (m.OcmKind.LOCAL_HOST, m.OcmKind.LOCAL_DEVICE):
        h = ctx.alloc(1024, kind)
        ctx.free(h)
        with pytest.raises(m.OcmInvalidHandle):
            ctx.put(h, np.zeros(16, np.uint8))
        with pytest.raises(m.OcmInvalidHandle):
            ctx.get(h)
        with pytest.raises(m.OcmInvalidHandle):
            ctx.free(h)
    with pytest.raises(m.OcmConnectError):
        ctx.alloc(1024, m.OcmKind.REMOTE_DEVICE)
    with pytest.raises(m.OcmOutOfMemory):
        ctx.alloc(9 << 20, m.OcmKind.LOCAL_DEVICE)
    return []


def case_scrub_on_free(pkg, ctx, rng):
    m, out = pkg.mod, []
    for kind in (m.OcmKind.LOCAL_HOST, m.OcmKind.LOCAL_DEVICE):
        h = ctx.alloc(64 << 10, kind)
        ctx.put(h, rng.integers(1, 256, 64 << 10, dtype=np.uint8))
        off = h.extent.offset
        ctx.free(h)
        h = ctx.alloc(64 << 10, kind)
        out.append((h.extent.offset == off, int(_np(ctx.get(h)).sum())))
        ctx.free(h)
    return out


def case_onesided_and_named_api(pkg, ctx, rng):
    m, out = pkg.mod, []
    data = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    for kind in (m.OcmKind.LOCAL_HOST, m.OcmKind.LOCAL_DEVICE):
        h = ctx.alloc(1 << 16, kind)
        m.ocm_copy_in(ctx, h, data)
        out.append(_np(m.ocm_copy_out(ctx, h)))
        m.ocm_copy_in(ctx, h, data[:1024], offset=2048)
        out.append(_np(m.ocm_copy_out(ctx, h, nbytes=1024, offset=2048)))
        m.ocm_copy_onesided(ctx, h, data[:4096], "write")
        out.append(_np(m.ocm_copy_onesided(ctx, h, data[:512], "read")))
        payload = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
        ctx.put(h, payload)
        ctx.put(h, bytearray(16), offset=100)
        out.append(_np(ctx.get(h, 4096)))
        out.append(_np(m.ocm_copy_onesided(ctx, h, local=b"\0" * 16, op="read")))
        ctx.free(h)
    return out


def case_churn(pkg, ctx, rng):
    m = pkg.mod
    kinds = (m.OcmKind.LOCAL_HOST, m.OcmKind.LOCAL_DEVICE)
    for _ in range(20):
        hs = [ctx.alloc(64 << 10, k) for k in kinds for _ in range(4)]
        offsets = [h.extent.offset for h in hs]
        for h in hs:
            ctx.free(h)
    return [offsets, ctx.host_arena.allocator.bytes_live,
            ctx.device_arenas[0].allocator.bytes_live]


CASES = [case_lifecycle, case_put_get, case_bounds, case_typed_roundtrip,
         case_copy_matrix, case_copy_offsets, case_use_after_free,
         case_scrub_on_free, case_onesided_and_named_api, case_churn]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_ocm_test_cases_match_jax(case):
    results = {}
    for name, pkg in PKGS.items():
        ctx = _ctx(pkg)
        try:
            results[name] = case(pkg, ctx, np.random.default_rng(1234))
        finally:
            ctx.tini()
    _same(results["jax"], results["torch"])


def test_device_arm_returns_tensors_on_the_context_device():
    ctx = _ctx(PKGS["torch"])
    h = ctx.alloc(4096, tocm.OcmKind.LOCAL_DEVICE)
    got = ctx.get(h)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.uint8
    out = torch.empty(4096, dtype=torch.uint8)
    assert ctx.get(h, out=out) is out
    ctx.tini()
    assert h.freed


# -- the package boundary -----------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "oncilla_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        (f.relative_to(ROOT).as_posix(), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "oncilla_tpu")
    ]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    from oncilla_tpu_torch.benchmarks import kv_decode
    from oncilla_tpu_torch.models import llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tocm.OcmConfig(host_arena_bytes=1 << 20, device_arena_bytes=1 << 20)
    with pytest.raises(tocm.OcmDeviceError):
        tocm.ocm_init(cfg)
    with pytest.raises(tocm.OcmDeviceError):
        tocm.ocm_init(cfg, device="cuda:0")
    with pytest.raises(tocm.OcmDeviceError):
        TorchArena(1 << 20)
    with pytest.raises(tocm.OcmDeviceError):
        llama.init_params(llama.LlamaConfig.tiny())
    with pytest.raises(tocm.OcmDeviceError):
        kv_decode.run_bench(tokens_n=8, page_tokens=8, config="tiny")
    ctx = tocm.ocm_init(cfg, device="cpu")  # the CPU only when asked for
    assert ctx.device_arenas[0].buffer.device.type == "cpu"


def test_control_plane_config_raises(tmp_path):
    """A nodefile that is not there raises what the JAX package raises for
    it (``open``'s FileNotFoundError); one that names no live daemon raises
    ``OcmConnectError`` once the connect ladder has run out."""
    from oncilla_tpu_torch.runtime.cluster import free_ports

    kw = dict(host_arena_bytes=1 << 20, device_arena_bytes=1 << 20)
    missing = str(tmp_path / "nodes.txt")
    raised = []
    for init in (lambda: jocm.ocm_init(jocm.OcmConfig(nodefile=missing, **kw)),
                 lambda: tocm.ocm_init(tocm.OcmConfig(nodefile=missing, **kw),
                                       device="cpu")):
        with pytest.raises(OSError) as ei:
            init()
        raised.append(type(ei.value))
    assert raised == [FileNotFoundError, FileNotFoundError]
    dead = tmp_path / "dead"
    dead.write_text("".join(f"{r} 127.0.0.1 {p}\n"
                            for r, p in enumerate(free_ports(2))))
    with pytest.raises(tocm.OcmConnectError):
        tocm.ocm_init(tocm.OcmConfig(nodefile=str(dead), rank=0,
                                     connect_retries=1, connect_backoff_s=0.01,
                                     **kw), device="cpu")
