"""The port's copy of ``oncilla_tpu/fabric/__main__.py``, line for line, with
the imports renamed to the port's modules. Its smoke runs on
``inprocess_cluster`` (the JAX package's in-process ``local_cluster``).

``python -m oncilla_tpu_torch.fabric --smoke`` — the CI fabric gate.

Proves the shm fabric end to end on one host, in seconds: a 2-daemon
local cluster with segment-backed arenas, a put/get roundtrip that must
actually RIDE shm (asserted via the transfer ring's fabric tag, not
inferred from config) and come back byte-exact, server-side negotiation
and op counters, and clean teardown — registries and arenas drained,
the alloctrace ledger empty, and no segment name left in /dev/shm.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _assert(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def run_smoke(nbytes: int = 4 << 20) -> dict:
    import numpy as np

    from oncilla_tpu_torch.analysis import alloctrace
    from oncilla_tpu_torch.core.kinds import OcmKind
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
    from oncilla_tpu_torch.utils.config import OcmConfig

    os.environ.setdefault("OCM_ALLOCTRACE", "1")
    alloctrace.reset()
    cfg = OcmConfig(
        host_arena_bytes=nbytes + (1 << 20),
        device_arena_bytes=1 << 20,
        chunk_bytes=256 << 10,
        heartbeat_s=5.0,
        fabric="shm",
        fabric_shm_min_bytes=4 << 10,
    )
    out: dict = {"nbytes": nbytes}
    seg_names = []
    with inprocess_cluster(2, config=cfg) as cl:
        for d in cl.daemons:
            _assert("shm" in d.fabrics,
                    f"rank {d.rank} did not register the shm fabric")
            seg_names.append(d.fabrics["shm"]._shm.name)
        client = cl.client(0, heartbeat=False)
        h = client.alloc(nbytes, OcmKind.REMOTE_HOST)
        data = np.random.default_rng(7).integers(
            0, 256, nbytes, dtype=np.uint8
        )
        client.put(h, data)
        got = client.get(h, nbytes)
        _assert(bool(np.array_equal(got, data)),
                "shm roundtrip not byte-exact")
        rec = client.tracer.transfers()[-2:]
        _assert([r.get("fabric") for r in rec] == ["shm", "shm"],
                f"transfer rode {rec} — shm negotiation failed on the "
                "one host where it never should")
        owner = cl.daemons[h.rank]
        fc = owner.fabric_counters
        _assert(fc["selected_shm"] >= 1 and fc["shm_puts"] >= 1
                and fc["shm_gets"] >= 1,
                f"fabric counters did not move: {fc}")
        out["put_bytes_served"] = fc["shm_put_bytes"]
        client.free(h)
        for d in cl.daemons:
            _assert(d.registry.live_count() == 0,
                    f"rank {d.rank} registry not drained")
            _assert(d.host_arena.allocator.bytes_live == 0,
                    f"rank {d.rank} arena not drained")
    leaked = alloctrace.live()
    _assert(not leaked,
            f"alloctrace ledger leaked: {[r.describe() for r in leaked]}")
    for n in seg_names:
        _assert(not os.path.exists(f"/dev/shm/{n}"),
                f"segment {n} leaked in /dev/shm after stop")
    out["verified"] = True
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one-sided fabric layer smoke (fabric/)"
    )
    ap.add_argument("--smoke", action="store_true",
                    help="shm put/get roundtrip on a 2-daemon local "
                         "cluster: byte-exact, counters moved, ledger "
                         "drained, no /dev/shm leak")
    ap.add_argument("--nbytes", type=int, default=4 << 20)
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.print_help()
        return 2
    try:
        out = run_smoke(args.nbytes)
    except AssertionError as e:
        print(f"fabric smoke: FAILED — {e}", file=sys.stderr)
        return 1
    print("fabric smoke: OK", json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
