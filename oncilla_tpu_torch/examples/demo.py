"""End-to-end walkthrough of the port: the counterpart of the JAX
package's ``examples/demo.py``.

Covers the reference's user journey (alloc -> put/get -> copy -> free,
the reference's test/ocm_test.c) plus what this framework adds on top: a
two-node cluster of in-process daemons, a training checkpoint into the
other node's DRAM, and a paged-KV decode. Each section prints the JAX
demo's lines and returns its figures.

Run from the repository's root, on the card:

    python -m oncilla_tpu_torch.examples.demo

and on the CPU with ``--device cpu``. Without CUDA and without that flag
it raises ``OcmDeviceError``, like every entry point of the port.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import oncilla_tpu_torch as ocm
from oncilla_tpu_torch import OcmKind


def local_memory(device) -> dict:
    print("== 1. Local allocations (ocm_test.c test 1/2 shape) ==")
    # Ocm is a context manager: leaving the block runs tini(), which
    # reclaims any handle the app forgot (and — with OCM_ALLOCTRACE=1 —
    # reports each leak's allocation site).
    with ocm.ocm_init(ocm.OcmConfig(
        host_arena_bytes=32 << 20, device_arena_bytes=32 << 20,
    ), device=device) as ctx:
        h = ctx.alloc(1 << 20, OcmKind.LOCAL_DEVICE)
        data = np.random.default_rng(0).integers(
            0, 256, 1 << 20, dtype=np.uint8
        )
        ctx.put(h, data)                       # one-sided write
        back = ctx.get(h).cpu().numpy()        # one-sided read
        assert np.array_equal(back, data)
        print(f"   put/get {h.nbytes >> 10} KiB on {h.kind.name}: "
              "roundtrip ok")

        h2 = ctx.alloc(1 << 20, OcmKind.LOCAL_HOST)
        ctx.copy(h2, h)                        # kind×kind copy matrix
        copied = ctx.get(h2).numpy()
        assert np.array_equal(copied, data)
        print("   device->host ocm_copy: ok")
        ctx.free(h), ctx.free(h2)
    return {"kib": h.nbytes >> 10, "kind": h.kind.name, "bytes": back,
            "copied": copied}


def cluster_and_checkpoint(device) -> dict:
    print("== 2. Two-node cluster: remote DRAM + training checkpoint ==")
    from oncilla_tpu_torch.models import checkpoint as ckpt
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster

    cfg = ocm.OcmConfig(
        host_arena_bytes=16 << 20, device_arena_bytes=1 << 20,
        chunk_bytes=256 << 10, heartbeat_s=0.5, lease_s=30.0,
    )
    # The JAX package's in-process local_cluster: daemons in this process.
    with inprocess_cluster(2, config=cfg) as cluster:
        ctx = cluster.context(0, device=device)
        h = ctx.alloc(2 << 20, OcmKind.REMOTE_HOST)
        print(f"   alloc placed on rank {h.rank} "
              f"(origin 0; is_remote={h.is_remote})")
        payload = np.arange(2 << 20, dtype=np.uint8)
        ctx.put(h, payload)
        back = ctx.get(h).numpy()
        assert np.array_equal(back, payload)
        print("   one-sided put/get across the (loopback) DCN fabric: ok")
        ctx.free(h)

        # A small "train state" checkpointed into the other node's memory.
        w = np.random.default_rng(1).standard_normal((256, 128))
        state = {
            "w": torch.from_numpy(w).to(device=device, dtype=torch.bfloat16),
            "step": torch.tensor(1234, dtype=torch.int32, device=device),
        }
        hc = ckpt.save(ctx, state, OcmKind.REMOTE_HOST)
        restored = ckpt.load(ctx, hc, like=state)
        assert int(restored["step"]) == 1234
        assert torch.equal(restored["w"], state["w"])
        print(f"   checkpoint ({hc.nbytes >> 10} KiB) saved to rank "
              f"{hc.rank} DRAM and restored: ok")
        ctx.free(hc)
    return {"rank": h.rank, "is_remote": h.is_remote, "bytes": back,
            "checkpoint_kib": hc.nbytes >> 10, "checkpoint_rank": hc.rank,
            "restored": {k: v.cpu() for k, v in restored.items()}}


def model_and_paged_decode(device, params: dict | None = None,
                           decode_params: dict | None = None) -> dict:
    """Three train steps of ``LlamaConfig.tiny()``, then 24 paged decode
    steps. ``params`` starts training from given weights (the port's
    seeded init when None); ``decode_params`` decodes from given weights
    instead of the trained ones."""
    print("== 3. Flagship model: train step + OCM-paged decode ==")
    from oncilla_tpu_torch.models import llama, train
    from oncilla_tpu_torch.models.kv_paging import BucketedPagedDecoder

    cfg = llama.LlamaConfig.tiny()
    mesh = train.make_mesh(device=device)  # one process: a mesh of one
    if params is None:
        params, opt_state, tx = train.make_train_state(
            cfg, torch.Generator(device=mesh.device).manual_seed(0),
            lr=1e-2, mesh=mesh,
        )
    else:
        params, opt_state, tx = train.make_sharded_state(
            params, train.param_specs(cfg), mesh, lr=1e-2
        )
    step = train.make_train_step(cfg, tx, mesh=mesh)
    tokens = train.shard_batch(
        train.sample_batch(np.random.default_rng(2), cfg, 4, 32, "cpu"),
        mesh, train.data_spec(),
    ).to(mesh.device)
    losses = []
    for i in range(3):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    print(f"   3 sharded train steps on mesh {dict(mesh.shape)}: "
          f"loss={losses[-1]:.3f}")

    with ocm.ocm_init(ocm.OcmConfig(
        host_arena_bytes=16 << 20, device_arena_bytes=4 << 20,
    ), device=device) as ctx:
        dec = BucketedPagedDecoder(
            params if decode_params is None else decode_params, cfg, ctx,
            batch=1, page_tokens=8, kind=OcmKind.LOCAL_HOST, dtype="float32",
        )
        ids = np.random.default_rng(3).integers(
            0, cfg.vocab, 24, dtype=np.int32
        )
        logits = None
        for t in ids:
            logits = dec.step(torch.tensor([t], device=mesh.device))
        pages = len(dec.cache.pages)
        print(f"   24 decode steps, KV paged through OCM "
              f"({pages} pages shipped): logits {tuple(logits.shape)}")
        dec.close()
    return {"mesh": dict(mesh.shape), "losses": losses, "pages": pages,
            "logits": logits.float().cpu()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from oncilla_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    local_memory(device)
    cluster_and_checkpoint(device)
    model_and_paged_decode(device)
    print("demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
