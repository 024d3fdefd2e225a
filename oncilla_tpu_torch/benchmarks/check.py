"""Grade a JSON line of the port's bench (:mod:`.bench`) against its targets:
bench.py's six rows (``oncilla_tpu/benchmarks/check.py``), on the port's
keys and the card's own yardsticks.

    python -m oncilla_tpu_torch.benchmarks.check BENCH_LINE.json

Rows:
1. the headline copy rate is at least 80 % of the card's datasheet memory
   rate (``vs_hbm >= 0.80``: the north star's "80 % of line rate");
2. the gb_sweep read leg at 1 GiB (the amortized leg where present) is at
   least half the copy loop's rate (``copy_loop_gbps``);
3. the ceiling probe banked its read-only and staged-copy legs;
4. train MFU >= 0.60 (the JAX grader's threshold, against the card's
   datasheet dense bf16 rate);
5. paged ``device_fused`` decode >= ``plain`` tokens/s;
6. the wire legs (``detail.dcn``, :func:`.bench.bench_dcn`) banked and
   verified: every cell's bytes read back equal to what was put.
"""

from __future__ import annotations

import json
import sys

TARGET_VS_HBM = 0.80


def grade(doc: dict) -> list[tuple[str, str, str]]:
    """(target, verdict, evidence) rows; verdict in PASS / FAIL / NO DATA."""
    d = doc.get("detail", {})
    rows: list[tuple[str, str, str]] = []

    def row(name, ok, evidence):
        rows.append((name, "NO DATA" if ok is None else
                     ("PASS" if ok else "FAIL"), evidence))

    # 1. Headline copy bandwidth against 80 % of the card's memory rate.
    v = doc.get("value") or 0.0
    vs = doc.get("vs_hbm") or 0.0
    row(f"headline copy >= {TARGET_VS_HBM:.2f} of HBM (vs_hbm)",
        None if not v else vs >= TARGET_VS_HBM,
        f"value={doc.get('value')} GB/s vs_hbm={doc.get('vs_hbm')}")

    # 2. GB-sweep read leg within 2x of the copy loop's rate.
    sweep = d.get("gb_sweep") or {}
    loop = d.get("copy_loop_gbps")

    def best_read(legs):
        """The amortized leg (legs[2]) when present, else the per-op leg."""
        if not isinstance(legs, list):
            return None
        if len(legs) > 2 and legs[2]:
            return legs[2]
        return legs[1] if len(legs) > 1 else None

    read_1g = None
    for size, legs in sweep.items():
        if str(size) in ("1073741824", "1g", "1G"):
            read_1g = best_read(legs)
    if read_1g is None and sweep:
        # The largest size present.
        try:
            k = max((s for s in sweep if str(s).isdigit()), key=int)
            read_1g = best_read(sweep[k])
        except (ValueError, TypeError):
            read_1g = None
    row("GB-sweep read leg >= copy_loop_gbps / 2",
        None if read_1g is None or not loop else read_1g >= loop / 2,
        f"read={read_1g} GB/s copy_loop={loop} GB/s")

    # 3. Ceiling probe ran. -1 marks a leg skipped by the stage deadline:
    #    partial evidence is NO DATA (rerun with more budget), not FAIL.
    ceil = d.get("ceiling") or {}
    complete = ceil and all(
        ceil.get(k, -1) not in (None, -1)
        for k in ("read_only_gbps", "vmem_roundtrip_gbps")
    )
    row("ceiling probe banked (read_only + stream sweep)",
        True if complete else None,
        json.dumps(ceil) if ceil else "absent")

    # 4. Train MFU >= 0.60: the best variant of the mfu_train stage.
    mfu_t = d.get("mfu_train")
    row("mfu_train >= 0.60", None if mfu_t is None else mfu_t >= 0.60,
        f"mfu_train={mfu_t} variants={len(d.get('mfu_train_variants') or [])}")

    # 5. Page-fused paged decode >= plain decode tok/s.
    kv = d.get("kv_decode_tok_s") or {}
    fused, plain = kv.get("device_fused"), kv.get("plain")
    row("paged device_fused >= plain tok/s",
        None if fused is None or plain is None else fused >= plain,
        f"device_fused={fused} plain={plain}")

    # 6. DCN daemon-path bandwidth recorded and verified.
    dcn = d.get("dcn") or {}
    row("dcn banked and verified",
        None if not dcn else bool(dcn.get("verified")),
        json.dumps(dcn) if dcn else "absent")
    return rows


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print("usage: python -m oncilla_tpu_torch.benchmarks.check BENCH_LINE.json",
              file=sys.stderr)
        return 2
    with open(argv[1]) as f:
        doc = json.loads(f.read().strip().splitlines()[-1])
    rows = grade(doc)
    width = max(len(r[0]) for r in rows)
    for name, verdict, evidence in rows:
        print(f"{name:<{width}}  {verdict:<8}  {evidence}")
    return 0 if all(v != "FAIL" for _, v, _ in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
