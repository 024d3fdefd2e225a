"""Train the same tiny models four ways: every parallelism axis of the
port's training steps, one process a card.

1. dense  (dp, tp, sp): tensor-parallel heads, ffn and vocab, ring
   attention over sp
2. moe    (dp, ep, tp): experts over ep, global routing
3. gpipe  (dp, pp):     dense layers through the pipeline executor
4. moe-pp (dp, pp):     MoE layers through the pipeline (aux channel)

The counterpart of the JAX package's ``examples/train_parallel.py``. Run
from the repository's root, on the cards:

    torchrun --nproc-per-node 4 -m oncilla_tpu_torch.examples.train_parallel
    python -m oncilla_tpu_torch.examples.train_parallel --nprocs 4

and on the CPU (gloo processes) with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def _run(name, mesh, make_state, make_step, cfg, batch, seq, spec, steps=4):
    from oncilla_tpu_torch.models import train

    params, opt, tx = make_state(cfg, lr=5e-3, mesh=mesh, seed=0)
    step = make_step(cfg, tx, mesh=mesh)
    rng = np.random.default_rng(0)
    tokens = train.shard_batch(train.sample_batch(rng, cfg, batch, seq, "cpu"),
                               mesh, spec).to(mesh.device)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses} not finite or not falling")
    return (f"  {name:8s} mesh={mesh.shape} "
            f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


def worker(device: str = "cuda") -> list[str]:
    """The four runs on this process's card (or the CPU): one line each."""
    import torch.distributed as dist

    from oncilla_tpu_torch.models import train
    from oncilla_tpu_torch.models.llama import LlamaConfig
    from oncilla_tpu_torch.models.moe import MoeConfig
    from oncilla_tpu_torch.parallel.mesh import P

    n = dist.get_world_size() if dist.is_initialized() else 1
    dev = "cpu" if device == "cpu" else None
    dense = LlamaConfig.tiny()
    moe = MoeConfig.tiny()
    pp_dense = dataclasses.replace(dense, n_layers=4)
    lines = [f"== training across {n} processes ({device}) =="]
    lines.append(_run("dense", train.make_mesh(n, device=dev),
                      train.make_train_state, train.make_train_step, dense,
                      batch=4, seq=32, spec=train.data_spec()))
    lines.append(_run("moe", train.make_moe_mesh(n, device=dev),
                      train.make_moe_train_state, train.make_moe_train_step,
                      moe, batch=4, seq=32, spec=P("dp", None)))
    lines.append(_run("gpipe", train.make_pp_mesh(n, n_layers=4, device=dev),
                      train.make_pp_train_state, train.make_pp_train_step,
                      pp_dense, batch=8, seq=32, spec=P("dp", None)))
    lines.append(_run("moe-pp", train.make_pp_mesh(n, n_layers=moe.n_layers,
                                                   device=dev),
                      train.make_moe_pp_train_state,
                      train.make_moe_pp_train_step, moe, batch=8, seq=32,
                      spec=P("dp", None)))
    lines.append("all four parallelism modes trained")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=0,
                    help="spawn this many processes (else: torchrun's world, "
                         "or one process)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from oncilla_tpu_torch.parallel.launch import init_from_env, spawn

    if args.nprocs:
        lines = spawn("oncilla_tpu_torch.examples.train_parallel:worker",
                      args.nprocs, args=(args.device,), device=args.device,
                      timeout=600)[0]
    else:
        rank, _ = init_from_env(args.device)
        lines = worker(args.device)
        if rank != 0:
            return 0
    print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
