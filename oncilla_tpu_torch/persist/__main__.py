"""``python -m oncilla_tpu_torch.persist`` — the FROZEN-tier smoke, the port's
copy of ``oncilla_tpu/persist/__main__.py``: the same legs on the port's
store, chaos harness, auditor and in-process daemons
(``runtime/cluster.inprocess_cluster``).

``--smoke`` (host only: the daemons make no CUDA context) proves the
persist/ subsystem end to end:

- **store leg**: :class:`FrozenStore` round-trip (write → reopen →
  byte-exact read), then one byte of a stored file is flipped — the
  reopened store must refuse the entry WHOLE with a typed
  ``OcmFrozenCorrupt``, quarantine the file, and report the extent on
  ``lost`` (a half-truth manifest is worse than an empty one);
- **cluster leg**, TWICE with identical seeded interleavings: acked
  writes on a 1 MiB-arena daemon are pushed over the high watermark,
  the reaper demotes PRIO_LOW victims to FROZEN (``tier_demote``,
  never ``destroyed``), reads thaw them byte-exact (``tier_promote``),
  pressure re-freezes them, then the chaos ``restart`` action
  hard-kills the daemon and relaunches a fresh incarnation at the same
  address — which re-adopts every surviving extent from disk
  (``warm_boot``) and serves the SAME handles byte-exact to a new
  client. Frees then drain the frozen dir, the registry, and the
  OCM_ALLOCTRACE ledger; both runs are wrapped in the flight-recorder
  invariant audit (``audit.recorded`` — zero findings) and must
  produce identical chaos logs and adoption counts.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def _store_leg() -> None:
    from oncilla_tpu_torch.core.errors import OcmError
    from oncilla_tpu_torch.persist import FrozenStore, OcmFrozenCorrupt
    from oncilla_tpu_torch.persist.store import _fname
    from oncilla_tpu_torch.resilience.chaos import corrupt_file

    with tempfile.TemporaryDirectory() as d:
        st = FrozenStore(d)
        payload = bytes(range(256)) * 64
        st.write("alloc-42", payload, meta={"kind": "REMOTE_HOST"})
        st.write("alloc-43", b"x" * 512, meta={"kind": "REMOTE_HOST"})
        re1 = FrozenStore(d)
        if re1.read_bytes("alloc-42") != payload or re1.lost:
            raise AssertionError("round-trip through reopen not byte-exact")
        corrupt_file(os.path.join(d, _fname("alloc-42")), offset=300)
        re2 = FrozenStore(d)
        if [ls.key for ls in re2.lost] != ["alloc-42"]:
            raise AssertionError(
                f"corrupt entry not reported lost: {re2.lost}"
            )
        if re2.has("alloc-42") or not re2.has("alloc-43"):
            raise AssertionError("quarantine refused the wrong entry")
        try:
            re1.read_bytes("alloc-42")
        except OcmFrozenCorrupt as exc:
            if not isinstance(exc, OcmError):
                raise AssertionError("OcmFrozenCorrupt is not an OcmError")
        else:
            raise AssertionError(
                "corrupt read returned bytes instead of a typed refusal"
            )
        print(f"  store: round-trip byte-exact; 1 byte flipped -> "
              f"typed OcmFrozenCorrupt, entry quarantined WHOLE, "
              f"lost={[ls.key for ls in re2.lost]}")


def _cluster_run(seed: int) -> dict:
    """One demote → restart → warm-boot → promote scenario. Returns the
    replay-identity evidence (chaos log, adoption count, survivors)."""
    import numpy as np

    from oncilla_tpu_torch.analysis import alloctrace
    from oncilla_tpu_torch.core.kinds import OcmKind
    from oncilla_tpu_torch.resilience.chaos import ChaosController, ChaosSchedule
    from oncilla_tpu_torch.runtime.cluster import inprocess_cluster
    from oncilla_tpu_torch.utils.config import OcmConfig

    alloctrace.reset()
    with tempfile.TemporaryDirectory() as frz:
        cfg = OcmConfig(
            host_arena_bytes=1 << 20, device_arena_bytes=1 << 20,
            chunk_bytes=64 << 10, heartbeat_s=0.2,
            frozen_dir=frz, priority=0,      # PRIO_LOW: demotable while live
            arena_high_pct=70, arena_low_pct=40,
        )
        nb = 200 << 10
        with inprocess_cluster(1, config=cfg) as cl:
            c = cl.client(0)
            d = cl.daemons[0]
            rng = np.random.default_rng(seed)
            hs, datas = [], []
            for _ in range(4):  # 800 KiB of acked writes in a 1 MiB arena
                h = c.alloc(nb, OcmKind.REMOTE_HOST)
                data = rng.integers(0, 256, nb, dtype=np.uint8)
                c.put(h, data)
                hs.append(h)
                datas.append(data)
            d._pressure_evict()
            if d.frz_counters["demotes"] < 1:
                raise AssertionError("pressure eviction demoted nothing")
            for h, data in zip(hs, datas):  # thaw: byte-exact promote
                if not np.array_equal(c.get(h, nb), data):
                    raise AssertionError("thawed read not byte-exact")
            if d.frz_counters["promotes"] < 1:
                raise AssertionError("reads never promoted from FROZEN")
            d._pressure_evict()  # re-freeze before the hard kill
            nfrozen = sum(1 for e in d.registry.snapshot() if e.frozen)
            if nfrozen < 1:
                raise AssertionError("no frozen extents before the kill")
            controller = ChaosController(
                ChaosSchedule(seed=seed), cl.entries,
                restart_fn=cl.restart,
            )
            # The client stays LIVE across the restart — a daemon crash
            # must not be mistaken for the app disconnecting.
            controller.force("restart", 0)
            d2 = cl.daemons[0]
            if d2.frz_counters["warm_boot_extents"] != nfrozen:
                raise AssertionError(
                    f"warm boot adopted "
                    f"{d2.frz_counters['warm_boot_extents']} extents, "
                    f"expected {nfrozen}"
                )
            c2 = cl.client(0)
            survivors = {e.alloc_id for e in d2.registry.snapshot()}
            ok = 0
            for h, data in zip(hs, datas):
                if getattr(h, "alloc_id", None) in survivors:
                    if not np.array_equal(c2.get(h, nb), data):
                        raise AssertionError(
                            "post-restart read not byte-exact vs the "
                            "bytes acked before the kill"
                        )
                    ok += 1
                    c2.free(h)
            if ok != nfrozen:
                raise AssertionError(f"read back {ok} of {nfrozen} extents")
            if d2.registry.live_count() != 0 or d2._frozen.keys():
                raise AssertionError(
                    "frees did not drain the registry + frozen dir"
                )
            c.close()
            c2.close()
            log = list(controller.log)
        leaked = alloctrace.live()
        if leaked:
            raise AssertionError(
                f"alloctrace leaked: {[r.describe() for r in leaked]}"
            )
        return {"log": log, "nfrozen": nfrozen, "ok": ok,
                "survivors": sorted(survivors)}


def smoke(seed: int) -> int:
    from oncilla_tpu_torch.obs import audit as obs_audit

    os.environ.setdefault("OCM_ALLOCTRACE", "1")

    print(f"persist smoke: seed={seed} FrozenStore round-trip + "
          f"corrupt-refusal leg ...")
    _store_leg()

    print("persist smoke: demote -> chaos restart -> warm boot -> "
          "promote, two audited runs ...")
    runs = []
    for i in (1, 2):
        with obs_audit.recorded(f"persist-warmboot-{i}") as rec:
            runs.append(_cluster_run(seed))
        print(f"  run {i}: {runs[-1]['nfrozen']} extents frozen before "
              f"the kill, all {runs[-1]['ok']} re-adopted + read "
              f"byte-exact; chaos log {runs[-1]['log']}; "
              f"{rec.summary()}")
    if runs[0] != runs[1]:
        raise AssertionError(
            f"warm-boot replay diverged: {runs[0]} vs {runs[1]}"
        )
    print("persist smoke: OK — corrupt entries refused typed+whole, "
          "acked demoted bytes survive a hard kill byte-exact, warm "
          "boot re-adopts every extent, frozen dir and ledger drained, "
          "audit clean, replay identical")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m oncilla_tpu_torch.persist",
        description="FROZEN tier (disk-backed arenas + warm boot) smoke",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="host-only end-to-end proof")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.seed)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
