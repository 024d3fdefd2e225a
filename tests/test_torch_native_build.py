"""The port's native builds (``runtime/cluster.py``): the daemon
``oncillamemd``, its ThreadSanitizer variant ``oncillamemd_tsan`` and the C
client library ``libocm_tpu.so`` with its demo app, each cached on a stamp
of its own, a hash of the bytes of its sources, every header, the
compilers and the flags.

The first five cases are the JAX package's ``tests/test_native_build.py``
on the port's builds: a source edit rebuilds even when the mtime does not
move, as does a new header; a missing stamp counts as stale; and the TSan
variant keeps its own stamp. The compile steps are stubbed, so these need
no compiler; the last cases run the real compilers on broken sources and
without any, and each must raise ``OcmError`` with the compiler's
output."""

import os

import pytest

from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.runtime import cluster

_TREE = {
    "daemon.cc": "int main() { return 0; }\n",
    "protocol.cc": "// protocol\n",
    "obs.cc": "// obs\n",
    "libocm.cc": "// lib\n",
    "ocm_c_demo.c": "int main(void) { return 0; }\n",
    "net.hh": "// header\n",
    "ocm_client.h": "// C header\n",
}


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    """A miniature native source tree and build directory, the compile
    steps replaced by recorders that only drop the target files."""
    src = tmp_path / "native"
    src.mkdir()
    for name, text in _TREE.items():
        (src / name).write_text(text)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(cluster, "NATIVE_DIR", src)
    monkeypatch.setattr(cluster, "BUILD_DIR", build_dir)
    monkeypatch.setattr(cluster, "_compiler", lambda what="daemon": "c++")
    monkeypatch.setattr(cluster, "_c_compiler", lambda what="library": "cc")
    compiles = []

    def fake_daemon(cxx, flags, work, name):
        (work / name).write_bytes(b"\x7fELF fake")
        compiles.append(name)

    def fake_lib(cxx, cc, work):
        for name in ("libocm_tpu.so", "ocm_c_demo"):
            (work / name).write_bytes(b"\x7fELF fake")
        compiles.append("libocm_tpu.so")

    monkeypatch.setattr(cluster, "_compile_daemon", fake_daemon)
    monkeypatch.setattr(cluster, "_compile_lib", fake_lib)
    return src, build_dir, compiles


def test_build_caches_on_content_hash(fake_tree):
    src, build_dir, compiles = fake_tree
    t1 = cluster.build_daemon()
    assert t1 == build_dir / "oncillamemd" and t1.exists()
    assert compiles == ["oncillamemd"]
    # Unchanged tree: a cache hit, no recompile.
    assert cluster.build_daemon() == t1
    assert compiles == ["oncillamemd"]
    # The work directories are gone; the lock file stays.
    assert sorted(p.name for p in build_dir.iterdir()) == [
        ".lock", "oncillamemd", "oncillamemd.srchash"]


def test_source_edit_triggers_rebuild_even_with_frozen_mtime(fake_tree):
    src, build_dir, compiles = fake_tree
    cluster.build_daemon()
    daemon = src / "daemon.cc"
    stat = daemon.stat()
    # Same length, same mtime, different bytes: the edit an mtime probe
    # would wave through as fresh.
    daemon.write_text("int main() { return 1; }\n")
    os.utime(daemon, (stat.st_atime, stat.st_mtime))
    cluster.build_daemon()
    assert compiles == ["oncillamemd", "oncillamemd"]


def test_new_source_file_triggers_rebuild(fake_tree):
    src, build_dir, compiles = fake_tree
    cluster.build_daemon()
    (src / "extra.hh").write_text("// new header\n")
    cluster.build_daemon()
    assert compiles == ["oncillamemd", "oncillamemd"]


def test_missing_stamp_counts_as_stale(fake_tree):
    src, build_dir, compiles = fake_tree
    target = cluster.build_daemon()
    # A build directory with the binary but no stamp must rebuild.
    cluster._stamp(target).unlink()
    cluster.build_daemon()
    assert compiles == ["oncillamemd", "oncillamemd"]


def test_tsan_variant_keeps_its_own_stamp(fake_tree):
    src, build_dir, compiles = fake_tree
    cluster.build_daemon()
    assert cluster.build_daemon(tsan=True) == build_dir / "oncillamemd_tsan"
    assert compiles == ["oncillamemd", "oncillamemd_tsan"]
    # Both cached independently now.
    cluster.build_daemon()
    cluster.build_daemon(tsan=True)
    assert compiles == ["oncillamemd", "oncillamemd_tsan"]


def test_library_keeps_its_own_stamp(fake_tree):
    """The library's stamp covers its units, the demo and the headers: an
    edit of a library file rebuilds the library alone, an edit of the
    daemon's own units the daemon alone, and an edit of a unit both link
    (protocol.cc) both. A missing demo counts as stale."""
    src, build_dir, compiles = fake_tree

    def build_all():
        return (cluster.build_daemon(), cluster.build_daemon(tsan=True),
                cluster.build_lib())

    assert build_all()[2] == build_dir / "libocm_tpu.so"
    assert (build_dir / "ocm_c_demo").exists()
    assert compiles == ["oncillamemd", "oncillamemd_tsan", "libocm_tpu.so"]
    for name, rebuilt in (
            ("libocm.cc", ["libocm_tpu.so"]),
            ("ocm_c_demo.c", ["libocm_tpu.so"]),
            ("daemon.cc", ["oncillamemd", "oncillamemd_tsan"]),
            ("obs.cc", ["oncillamemd", "oncillamemd_tsan"]),
            ("protocol.cc", ["oncillamemd", "oncillamemd_tsan", "libocm_tpu.so"])):
        (src / name).write_text(_TREE[name] + "// edited\n")
        del compiles[:]
        build_all()
        assert compiles == rebuilt, name
    (build_dir / "ocm_c_demo").unlink()
    del compiles[:]
    build_all()
    assert compiles == ["libocm_tpu.so"]


@pytest.mark.parametrize("target", ["daemon", "tsan", "lib"])
def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch,
                                                         target):
    """The real compilers on a tree whose every unit is broken: the build
    raises with what the compiler said, and installs nothing."""
    src = tmp_path / "native"
    src.mkdir()
    for name in _TREE:
        (src / name).write_text("this is not C;\n" if name.endswith(
            (".cc", ".c")) else "// header\n")
    monkeypatch.setattr(cluster, "NATIVE_DIR", src)
    monkeypatch.setattr(cluster, "BUILD_DIR", tmp_path / "build")
    build = {"daemon": cluster.build_daemon,
             "tsan": lambda: cluster.build_daemon(tsan=True),
             "lib": cluster.build_lib}[target]
    with pytest.raises(OcmError, match="build failed") as ei:
        build()
    assert "error" in str(ei.value)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [".lock"]


@pytest.mark.parametrize("missing,target,message", [
    ("all", "daemon", "cannot build the daemon: no C\\+\\+ compiler"),
    ("all", "tsan", "cannot build the daemon: no C\\+\\+ compiler"),
    ("all", "lib", "cannot build the library: no C\\+\\+ compiler"),
    ("c", "lib", "cannot build the library: no C compiler"),
])
def test_a_missing_compiler_raises(monkeypatch, missing, target, message):
    which = cluster.shutil.which
    c_names = {"gcc", "cc", "my-cc"}
    monkeypatch.setenv("CC", "my-cc")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(cluster.shutil, "which", lambda name: (
        None if missing == "all" or name in c_names else which(name)))
    build = {"daemon": cluster.build_daemon,
             "tsan": lambda: cluster.build_daemon(tsan=True),
             "lib": cluster.build_lib}[target]
    with pytest.raises(OcmError, match=message):
        build()
