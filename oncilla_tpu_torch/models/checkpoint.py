"""Training-state checkpoint into oncilla memory: the counterpart of
``oncilla_tpu/models/checkpoint.py``, with its region layout byte for byte.

A tree of tensors (dicts, lists, tuples and named tuples of them: params,
the optimizer state, a step count) is packed into ONE allocation of any
kind (host DRAM, the card's arena, a remote host's memory) and moved with
one ``put``; ``load`` reads it back with one ``get``. The region:

- ``OCMCKPT2``, the manifest's length and ``data_start`` as u64
  little-endian, then the manifest, ``json.dumps({"leaves": [...]},
  sort_keys=True)``, each leaf's key, shape, numpy dtype name
  (``bfloat16`` included), offset from ``data_start`` and byte count;
- from ``data_start`` the leaves' bytes, each at a 128-byte-aligned offset;
- keys are the strings the JAX package's ``"/".join(str(p) for p in
  path)`` gives: ``['embed']`` for a dict key (dicts in sorted key order),
  ``[0]`` for a sequence index, ``.mu`` for a named tuple's field;
- zero bytes up to a multiple of 4096, the copy kernels' row: the one
  difference from the JAX package's region, which ends at the last leaf.
  It makes the region eligible for the kernels, so a save to LOCAL_DEVICE
  is one ``write_rows`` (K1) launch and a load one ``read_rows`` (K2).
  Each package reads the other's regions.

The region is packed where the tensors live (on the card when any leaf
is there), so a save to the card's arena never leaves the card. ``load``
returns tensors on the device asked for (the context's by default): the
region is read straight into one buffer there, and the leaves are views
into it. The legacy ``OCMCKPT1``
header (``data_start`` recomputed) still loads.

Sharded states (a tree of this process's shards, each leaf with a
``NamedSharding``): :func:`save_sharded` gathers each full leaf in turn and
packs it into the one region of :func:`save` on one process, which makes
the one put; :func:`load_sharded` restores the full leaves (read by every
process, or by one and broadcast) and keeps each process's slice under the
shardings it is given, which may name another mesh than the state was
saved from.
"""

from __future__ import annotations

import concurrent.futures
import json

import numpy as np
import torch

from oncilla_tpu_torch.core.handle import OcmAlloc
from oncilla_tpu_torch.core.kinds import OcmKind
from oncilla_tpu_torch.ops.dma import BLOCK
from oncilla_tpu_torch.utils.platform import resolve_device

_MAGIC = b"OCMCKPT2"
_MAGIC_V1 = b"OCMCKPT1"  # legacy: data_start recomputed from _ALIGN
_ALIGN = 128  # leaf data alignment inside the region

# numpy's dtype names, which the manifest carries.
_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint64: "uint64", torch.uint32: "uint32",
    torch.uint16: "uint16", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _dtype_name(dtype) -> str:
    return _NAMES[dtype] if isinstance(dtype, torch.dtype) else np.dtype(dtype).name


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are, anything else through
    ``np.asarray`` (as the JAX package reads leaves), bf16 included."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _walk(tree, path: str = ""):
    """Yield (key, leaf) in the JAX package's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), f"{path}/.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, f"{path}/[{i}]")
    else:
        yield path[1:], tree


def _rebuild(tree, fn, path: str = ""):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, f"{path}/[{k!r}]") for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), fn, f"{path}/.{n}")
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, fn, f"{path}/[{i}]")
                          for i, sub in enumerate(tree))
    return fn(path[1:], tree)


def _flatten(tree) -> list[tuple[str, torch.Tensor]]:
    return [(key, _as_tensor(leaf)) for key, leaf in _walk(tree)]


def _aligned(n: int, to: int = _ALIGN) -> int:
    return (n + to - 1) // to * to


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size() if isinstance(
        dtype, torch.dtype) else np.dtype(dtype).itemsize


def _layout(flat):
    """The ONE place the layout is decided: (manifest bytes, data_start,
    data_len), each manifest entry's offset relative to data_start.
    ``flat`` holds (key, leaf) pairs; only each leaf's shape and dtype are
    read."""
    entries = []
    off = 0
    for key, t in flat:
        nbytes = int(np.prod(t.shape, dtype=np.int64)) * _itemsize(t.dtype)
        entries.append({
            "key": key, "shape": list(t.shape), "dtype": _dtype_name(t.dtype),
            "offset": off, "nbytes": nbytes,
        })
        off = _aligned(off + nbytes)
    manifest = json.dumps({"leaves": entries}, sort_keys=True).encode()
    data_start = _aligned(len(_MAGIC) + 16 + len(manifest))
    return manifest, data_start, off


def checkpoint_nbytes(tree) -> int:
    """Size of the region that saves ``tree`` (its allocation's size)."""
    _, data_start, data_len = _layout(_flatten(tree))
    return _aligned(data_start + data_len, BLOCK)


def _pack(tree) -> torch.Tensor:
    """The region as one uint8 tensor, on the first card a leaf lies on,
    else on the CPU; the copies are queued on the current stream."""
    flat = _flatten(tree)
    dev = next((t.device for _, t in flat if t.is_cuda), torch.device("cpu"))
    region, entries, data_start = _region(flat, dev)
    for (_, t), ent in zip(flat, entries):
        _write_leaf(region, data_start, ent, t)
    return region


def _region(flat, dev):
    """The zeroed region of ``flat``'s layout on ``dev`` with its header
    written: (region, manifest entries, data_start)."""
    manifest, data_start, data_len = _layout(flat)
    region = torch.zeros(_aligned(data_start + data_len, BLOCK),
                         dtype=torch.uint8, device=dev)
    # data_start is written into the header (not recomputed at load), so
    # regions stay readable if the alignment policy changes.
    head = torch.frombuffer(bytearray(
        _MAGIC + len(manifest).to_bytes(8, "little")
        + data_start.to_bytes(8, "little") + manifest), dtype=torch.uint8)
    if dev.type == "cuda":
        head = head.pin_memory()
    region[:head.numel()].copy_(head, non_blocking=True)
    return region, json.loads(manifest)["leaves"], data_start


def _write_leaf(region, data_start: int, ent: dict, t: torch.Tensor) -> None:
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    o = data_start + ent["offset"]
    region[o:o + raw.numel()].copy_(raw, non_blocking=True)


def _ship(ctx, region: torch.Tensor, kind: OcmKind, alloc_kw: dict) -> OcmAlloc:
    handle = ctx.alloc(region.numel(), kind, **alloc_kw)
    try:
        ctx.put(handle, region, 0)
    except BaseException:
        ctx.free(handle)
        raise
    return handle


def save(ctx, tree, kind: OcmKind = OcmKind.LOCAL_HOST, **alloc_kw) -> OcmAlloc:
    """Pack ``tree`` into one allocation of ``kind`` with one ``put`` and
    return the handle; the caller owns it (``ctx.free`` releases it)."""
    return _ship(ctx, _pack(tree), kind, alloc_kw)


def save_async(ctx, tree, kind: OcmKind = OcmKind.LOCAL_HOST, **alloc_kw):
    """Checkpoint without stalling the training loop; returns a
    ``concurrent.futures.Future`` of the handle.

    The region is packed now, on the caller's stream: that copy is the
    snapshot, so steps that update the tree in place afterwards do not
    reach the checkpoint. A worker thread waits on an event recorded after
    the packing, then allocates and puts; the future resolves when the
    bytes are in place."""
    region = _pack(tree)
    packed = None
    if region.is_cuda:
        packed = torch.cuda.Event()
        packed.record(torch.cuda.current_stream(region.device))

    def ship():
        if packed is not None:
            packed.synchronize()
        handle = _ship(ctx, region, kind, alloc_kw)
        if region.is_cuda:
            # The put's kernel reads the region: done before it is freed.
            torch.cuda.current_stream(region.device).synchronize()
        return handle

    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        return ex.submit(ship)
    finally:
        ex.shutdown(wait=False)


def _host_bytes(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def load(ctx, handle: OcmAlloc, like=None, device=None):
    """Read a checkpoint back, its leaves on ``device`` (the context's
    device when None). With ``like`` (a tree of the same structure whose
    leaves have ``shape`` and ``dtype``), returns that structure; otherwise
    ``{key: tensor}`` keyed by the flattened paths."""
    dev = ctx.device if device is None else resolve_device(device)
    head = _host_bytes(ctx.get(handle, nbytes=len(_MAGIC) + 16, offset=0))
    magic, mlen = head[:8], int.from_bytes(head[8:16], "little")
    if magic == _MAGIC:
        data_start = int.from_bytes(head[16:24], "little")
        manifest_off = len(_MAGIC) + 16
    elif magic == _MAGIC_V1:
        data_start = _aligned(len(_MAGIC) + 8 + mlen)
        manifest_off = len(_MAGIC) + 8
    else:
        raise ValueError(f"not an OCM checkpoint (magic {magic!r})")
    manifest = json.loads(_host_bytes(
        ctx.get(handle, nbytes=mlen, offset=manifest_off)))
    # ONE get of the whole region from offset 0, straight into a buffer on
    # ``dev`` (on the card's arena, aligned: one read_rows launch; from
    # pinned host memory or the wire, one copy up), then views per entry.
    region = torch.empty(handle.nbytes, dtype=torch.uint8, device=dev)
    data = ctx.get(handle, out=region)[data_start:]
    leaves = {}
    for ent in manifest["leaves"]:
        o, n = int(ent["offset"]), int(ent["nbytes"])
        leaves[ent["key"]] = (data[o:o + n].view(_DTYPES[ent["dtype"]])
                              .reshape(ent["shape"]))
    if like is None:
        return leaves

    def restored(key, leaf):
        if key not in leaves:
            raise ValueError(f"checkpoint missing leaf {key!r}")
        got = leaves[key]
        want = _dtype_name(leaf.dtype)
        if tuple(got.shape) != tuple(leaf.shape) or _NAMES[got.dtype] != want:
            raise ValueError(
                f"leaf {key!r} mismatch: checkpoint {_NAMES[got.dtype]}"
                f"{tuple(got.shape)} vs expected {want}{tuple(leaf.shape)}")
        return got

    return _rebuild(like, restored)


# -- sharded states ------------------------------------------------------------


def _shardings_by_key(shardings) -> dict:
    return dict(_walk(shardings))


def full_like(tree, shardings):
    """``tree`` (this process's shards) as meta tensors of the full leaves'
    shapes and dtypes: the ``like`` of :func:`load_sharded`."""
    from oncilla_tpu_torch.parallel.mesh import full_shape

    by_key = _shardings_by_key(shardings)

    def meta(key, leaf):
        ns = by_key[key]
        return torch.empty(full_shape(leaf.shape, ns.mesh, ns.spec),
                           dtype=leaf.dtype, device="meta")

    return _rebuild(tree, meta)


def save_sharded(ctx, tree, shardings, kind: OcmKind = OcmKind.LOCAL_HOST,
                 **alloc_kw):
    """Save a sharded state as :func:`save` saves the whole one: every
    process of the mesh calls it; each full leaf is gathered in turn and
    copied into the region on process 0 (where ``ctx`` lives; the others
    pass None), so it holds one full leaf at a time beside the region, which
    it then puts with one ``put``. Returns the handle on process 0, None
    elsewhere."""
    import torch.distributed as dist

    from oncilla_tpu_torch.parallel.mesh import gather

    by_key = _shardings_by_key(shardings)
    flat = _flatten(tree)
    metas = full_like(tree, shardings)
    first = not dist.is_initialized() or dist.get_rank() == 0
    region = entries = data_start = None
    if first:
        dev = next((t.device for _, t in flat if t.is_cuda), torch.device("cpu"))
        region, entries, data_start = _region(_flatten(metas), dev)
    for i, (key, t) in enumerate(flat):
        ns = by_key[key]
        full = gather(t, ns.mesh, ns.spec)
        if first:
            _write_leaf(region, data_start, entries[i], full)
        del full
    return _ship(ctx, region, kind, alloc_kw) if first else None


def load_sharded(ctx, handle: OcmAlloc, like, shardings, src: int | None = None):
    """Restore a checkpoint and keep each process's slice of every leaf
    under ``shardings`` (a tree of ``NamedSharding`` matching ``like``,
    whose leaves give the full shapes and dtypes, e.g. :func:`full_like`'s):
    a sharded train state resumes on a mesh that may differ from the one it
    was saved from. Each process reads the checkpoint through its ``ctx``;
    with ``src``, process ``src`` alone reads it (one get) and broadcasts
    each leaf to the others, which pass ``ctx=None`` and ``handle=None``."""
    import torch.distributed as dist

    from oncilla_tpu_torch.parallel.mesh import shard

    by_key = _shardings_by_key(shardings)
    me = dist.get_rank() if dist.is_initialized() else 0
    full = load(ctx, handle) if src is None or me == src else None

    def place(key, leaf):
        ns = by_key[key]
        if src is None:
            got = full[key]
        elif me == src:
            got = full[key]
            dist.broadcast(got, src=src)
        else:
            got = torch.empty(leaf.shape, dtype=leaf.dtype, device=ns.mesh.device)
            dist.broadcast(got, src=src)
        if tuple(got.shape) != tuple(leaf.shape) or got.dtype != leaf.dtype:
            raise ValueError(f"leaf {key!r} mismatch: checkpoint "
                             f"{_NAMES[got.dtype]}{tuple(got.shape)} vs expected "
                             f"{_dtype_name(leaf.dtype)}{tuple(leaf.shape)}")
        return shard(got, ns.mesh, ns.spec)

    return _rebuild(like, place)
