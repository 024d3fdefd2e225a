"""Multi-process sharded training with a checkpoint into another
process's memory: the counterpart of the JAX package's
``examples/multihost_train.py`` and ``.sh``.

N processes (one a host, here all on this machine) form one
``torch.distributed`` world; membership comes from the process group
(``runtime.membership.torch_membership``: rank r's daemon on
``base_port + r``), each process runs one port daemon and attaches to it,
and the same step factories that train on one card train over one
(dp, tp, sp) mesh of all the processes. Process 0 gathers the trained
parameters and checkpoints them into a REMOTE_HOST allocation, which the
daemons place in another rank's arena (rank 1's, with two processes);
every process reads it back one-sided and checks it byte for byte against
the gathered leaves, and restores its own shards from it
(``load_sharded``).

Run from the repository's root:

    torchrun --nproc-per-node 2 -m oncilla_tpu_torch.examples.multihost_train
    python -m oncilla_tpu_torch.examples.multihost_train --nprocs 2 [--device cpu]

``--base-port 0`` (the default) lets rank 0 pick free ports for the
daemons; ``OCM_HOSTS`` names the hosts of a job spread over machines.
"""

from __future__ import annotations

import argparse
import os
import random
import socket
import sys
import tempfile

import numpy as np


def _free_base(n: int) -> int:
    """A base port with n free ports above it, on this machine."""
    for _ in range(200):
        base = random.randrange(20000, 60000 - n)
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise OSError(f"no {n} consecutive free ports found")


def _agree(value, src: int = 0):
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def worker(device: str = "cuda", base_port: int = 0) -> list[str]:
    """This process's part of the walkthrough; returns its report lines."""
    import torch
    import torch.distributed as dist

    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.core.arena import Extent
    from oncilla_tpu_torch.core.handle import OcmAlloc
    from oncilla_tpu_torch.core.kinds import Fabric
    from oncilla_tpu_torch.models import checkpoint, llama, train
    from oncilla_tpu_torch.parallel.mesh import NamedSharding
    from oncilla_tpu_torch.runtime.daemon import Daemon
    from oncilla_tpu_torch.runtime.membership import torch_membership

    n = dist.get_world_size()
    if base_port == 0:
        base_port = _agree(_free_base(n) if dist.get_rank() == 0 else None)
    # All on this machine unless OCM_HOSTS names the hosts by rank.
    hosts = None if os.environ.get("OCM_HOSTS") else ["localhost"] * n
    entries, me = torch_membership(base_port, hosts)
    daemon = Daemon(me, entries, config=ocm.OcmConfig(
        host_arena_bytes=64 << 20, device_arena_bytes=1 << 20))
    daemon.start()
    dist.barrier()  # every daemon listens before any client connects
    with tempfile.NamedTemporaryFile("w", suffix=".nodes", delete=False) as f:
        f.writelines(f"{e.rank} {e.host} {e.port}\n" for e in entries)
        nodefile = f.name
    dev = "cpu" if device == "cpu" else None
    ctx = ocm.ocm_init(ocm.OcmConfig(nodefile=nodefile, rank=me,
                                     host_arena_bytes=64 << 20,
                                     device_arena_bytes=1 << 20), device=dev)
    lines = []
    done = False
    try:
        cfg = llama.LlamaConfig(vocab=256, dim=64, n_layers=2, n_heads=4,
                                n_kv_heads=4, ffn_hidden=128, max_seq=64,
                                dtype="float32")
        mesh = train.make_mesh(device=dev)
        # numpy draws: every process makes the same full weights and keeps
        # its slice.
        params, opt, tx = train.make_train_state_host(0, cfg, mesh=mesh)
        step = train.make_train_step(cfg, tx, mesh=mesh)
        dp, sp = mesh.axis_size(train.DP), mesh.axis_size(train.SP)
        batch, seq = max(2 * dp, 2), 16 * sp
        rng = np.random.default_rng(0)  # the same stream everywhere
        tokens = train.shard_batch(train.sample_batch(rng, cfg, batch, seq, "cpu"),
                                   mesh).to(mesh.device)
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, tokens)
            losses.append(float(loss))  # the global loss, on every process
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"losses {losses} not finite or not falling")
        lines.append(f"proc {me}: mesh={mesh.shape} losses={losses}")

        # -- the checkpoint through the daemons ------------------------------
        full = train.gather_params(params, mesh, train.param_specs(cfg))
        h = None
        if me == 0:
            h = checkpoint.save(ctx, full, kind=ocm.OcmKind.REMOTE_HOST)
            if not h.is_remote or h.rank == 0:
                raise AssertionError(f"the checkpoint landed on rank {h.rank}")
        # The one-sided address goes to every process (the handle is
        # connectionless).
        addr = _agree((h.alloc_id, h.rank, h.extent.offset, h.nbytes)
                      if me == 0 else None)
        ghost = OcmAlloc(alloc_id=addr[0], kind=ocm.OcmKind.REMOTE_HOST,
                         fabric=Fabric.DCN, nbytes=addr[3], rank=addr[1],
                         device_index=0, extent=Extent(offset=addr[2],
                                                       nbytes=addr[3]),
                         origin_rank=0)
        restored = checkpoint.load(ctx, ghost, like=full, device="cpu")
        for k, v in full.items():
            if v.cpu().numpy().tobytes() != restored[k].numpy().tobytes():
                raise AssertionError(f"leaf {k} read back other bytes")
        lines.append(f"proc {me}: checkpoint of "
                     f"{checkpoint.checkpoint_nbytes(full)} B restored "
                     f"byte-exact from rank {ghost.rank}'s arena")
        # Each process restores its own shards of the same region.
        shardings = {k: NamedSharding(mesh, s)
                     for k, s in train.param_specs(cfg).items()}
        mine = checkpoint.load_sharded(
            ctx, ghost, checkpoint.full_like(params, shardings), shardings)
        if not all(torch.equal(mine[k], params[k]) for k in params):
            raise AssertionError("load_sharded restored other shards")
        lines.append(f"proc {me}: its shards restored bit for bit by load_sharded")
        dist.barrier()  # every process has read it
        if me == 0:
            ctx.free(h)
        del full, restored
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        done = True
    finally:
        ctx.tini()
        if done:  # a process that failed leaves at once, with its traceback
            dist.barrier()  # every client is gone before any daemon stops
        daemon.stop()
        os.unlink(nodefile)
    lines.append(f"proc {me}: ok")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=0,
                    help="spawn this many processes (else: torchrun's world)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--base-port", type=int, default=0)
    args = ap.parse_args(argv)
    from oncilla_tpu_torch.parallel.launch import init_from_env, spawn

    if args.nprocs:
        per_rank = spawn("oncilla_tpu_torch.examples.multihost_train:worker",
                         args.nprocs, args=(args.device, args.base_port),
                         device=args.device, timeout=300)
    else:
        rank, world = init_from_env(args.device)
        if world < 2:
            raise SystemExit("multihost_train needs two or more processes "
                             "(torchrun, or --nprocs N)")
        per_rank = [worker(args.device, args.base_port)]
        if rank != 0:
            print("\n".join(per_rank[0]), flush=True)
            return 0
    for lines in per_rank:
        print("\n".join(lines), flush=True)
    print("== multihost walkthrough ok ==", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
