"""Sharded training measured on the cards: the work of ``chip_smoke.py``'s
phase 9 (f) and (g) on one card and of ``--across-cards`` phase T.

- :func:`moe_train_card`: the MoE train step on a mesh of one at the
  configuration it is given (``chip_smoke`` gives Mixtral-8x7B widths, 2 of
  32 layers): steps on Zipf batches, step ms, tokens/s, MFU by the dense
  dispatch's FLOPs (:func:`moe_train_flops`), one ``remat`` and one
  ``ce_block`` step against the plain step, the state checkpointed to
  LOCAL_DEVICE and loaded back bit for bit with one K1 and one K2 launch.
- :func:`mesh_of_one_card`: two steps of the dense step on ``make_mesh(1)``
  against two of the one-device step, bit for bit.
- :func:`phase_t`: run by every process of a world (one a card, NCCL; gloo
  when the caller asks for the CPU): (a)-(d) the four families at the
  sizes given, (e) each family at a depth one card holds against the
  one-device step on the first process, (f) the MoE state of (e) resumed on
  another mesh through a LOCAL_DEVICE checkpoint, (g) the multi-process
  walkthrough (``examples/multihost_train.py``).

Every family reports step ms (median of the steps after the first), global
tokens/s, MFU against the world's datasheet peak, the bytes each process
handed to collectives in one step by mesh axes
(:func:`~oncilla_tpu_torch.parallel.collectives.traffic`) and one step under
``torch.profiler`` on the first process (the kernels, NCCL's among them,
that take most of its time). On the CPU the timings are the CPU's and MFU
is None.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from oncilla_tpu_torch.benchmarks.mfu import train_flops
from oncilla_tpu_torch.models import llama, moe, train
from oncilla_tpu_torch.ops import dma
from oncilla_tpu_torch.parallel import collectives as col
from oncilla_tpu_torch.parallel.mesh import DP, P, gather
from oncilla_tpu_torch.utils.platform import peak_flops

ZIPF_S = 1.1
LR = 3e-4


def zipf_batch(rng: np.random.Generator, vocab: int, batch: int, seq: int):
    """int32 (batch, seq) ids drawn with P(id) ~ 1 / (id + 1)^1.1, the
    skew of phase 9's stream."""
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** ZIPF_S
    return rng.choice(vocab, size=(batch, seq), p=p / p.sum()).astype(np.int32)


def moe_train_flops(cfg, batch: int, seq: int) -> dict:
    """A MoE train step's matmul FLOPs (3x the forward's): ``dense_dispatch``
    counts what the dense-dispatch formulation computes (every expert's C
    capacity slots, the dispatch and combine einsums); ``active_top_k``
    counts each token's k experts alone."""
    T, D, E, F = batch * seq, cfg.dim, cfg.n_experts, cfg.ffn_hidden
    kv = cfg.n_kv_heads * cfg.head_dim
    C = moe.capacity(cfg, T)
    attn = 2 * T * D * (2 * D + 2 * kv) + 4 * batch * cfg.n_heads * seq * seq * cfg.head_dim
    router = 2 * T * D * E
    head = 2 * T * D * cfg.vocab
    dense = attn + router + 2 * 2 * T * E * C * D + 3 * 2 * E * C * D * F
    active = attn + router + 3 * 2 * cfg.top_k * T * D * F
    return {"dense_dispatch": 3 * (cfg.n_layers * dense + head),
            "active_top_k": 3 * (cfg.n_layers * active + head), "capacity": C}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device, cards: int) -> float | None:
    if device.type != "cuda":
        return None
    return cards * peak_flops(torch.cuda.get_device_name(device))


def _profile(step, params, opt, tokens, device) -> dict:
    """One step under ``torch.profiler``: the device's busy share and the
    kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, opt, tokens)
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) * 1e-6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "device_busy_share": busy / wall if kernels else None,
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total * 1e-3
                               for e in top}}


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def run_steps(step, params, opt, batches, mesh, spec, device, *, flops: int,
              cards: int, profile: bool = True) -> dict:
    """``step`` over ``batches`` (global numpy batches, each process taking
    its ``spec`` slice), each step synchronised: losses (finite, the last
    below the first, else it raises), step ms, tokens/s, MFU, one step's
    collective bytes by axes, one profiled step on the first process."""
    losses, ms = [], []
    for i, b in enumerate(batches):
        tokens = train.shard_batch(b, mesh, spec).to(device)
        if i == len(batches) - 1:
            col.reset_traffic()
        _sync(device)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))  # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    traffic = col.traffic()
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite, or not falling")
    med = statistics.median(ms[1:] if len(ms) > 1 else ms)
    peak = _peak(device, cards)
    tokens = batches[0].size
    out = {"losses": losses, "step_ms": ms, "step_ms_median": med,
           "tokens_per_s": tokens / med * 1e3, "train_flops": flops,
           "mfu": flops / (med * 1e-3) / peak if peak else None,
           "collective_bytes_per_step": traffic}
    if profile:
        tokens_t = train.shard_batch(batches[-1], mesh, spec).to(device)
        if _rank() == 0:
            out["profile"] = _profile(step, params, opt, tokens_t, device)
        else:
            step(params, opt, tokens_t)
    return out


# -- one card ------------------------------------------------------------------


def _tree_equal(a, b) -> bool:
    from oncilla_tpu_torch.models.checkpoint import _walk

    la, lb = list(_walk(a)), list(_walk(b))
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(la, lb))


def _clone(params, opt):
    adam = opt[0]
    return ({k: v.clone() for k, v in params.items()},
            (type(adam)(adam.count.clone(), {k: v.clone() for k, v in adam.mu.items()},
                        {k: v.clone() for k, v in adam.nu.items()}), *opt[1:]))


def moe_train_card(device, cfg, batch: int, seq: int, *, steps: int = 8,
                   timing: bool = True, check_launches: bool = True) -> dict:
    """Phase 9 (f): the MoE step on a mesh of one (module docstring).
    The remat and ce_block steps are held to the plain step from the same
    state on the same batch: loss within rtol 1e-3 and every leaf's update
    within 20 % (in norm) of the plain step's, as the one-device bf16 step
    is held to JAX's (``tests/test_torch_train.py``)."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.models import checkpoint as ck

    t_phase = time.perf_counter()
    mesh = train.make_moe_mesh(1, device=device)
    params, opt, tx = train.make_moe_train_state(cfg, lr=LR, mesh=mesh, seed=0)
    step = train.make_moe_train_step(cfg, tx, mesh=mesh)
    rng = np.random.default_rng(11)
    # The training batch again every step, so the losses fall whatever the
    # seed; then a fresh batch for the trades.
    data = [zipf_batch(rng, cfg.vocab, batch, seq)] * steps + [
        zipf_batch(rng, cfg.vocab, batch, seq)]
    flops = moe_train_flops(cfg, batch, seq)
    dma.reset_launches()
    report = run_steps(step, params, opt, data[:steps], mesh, P(DP, None), device,
                       flops=flops["dense_dispatch"], cards=1, profile=timing)
    report.update(batch=batch, seq=seq, layers=cfg.n_layers,
                  flops_active_top_k=flops["active_top_k"],
                  capacity=flops["capacity"])

    # The state through a LOCAL_DEVICE checkpoint, bit for bit.
    state = {"params": params, "opt": opt}
    nbytes = ck.checkpoint_nbytes(state)
    w0, r0 = dma.write_rows.launches, dma.read_rows.launches
    with ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=1 << 20,
                                    device_arena_bytes=nbytes + (1 << 20)),
                      device=device) as ctx:
        _sync(device)
        t0 = time.perf_counter()
        h = ck.save(ctx, state, ocm.OcmKind.LOCAL_DEVICE)
        _sync(device)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ck.load(ctx, h, like=state)
        _sync(device)
        load_s = time.perf_counter() - t0
        same = _tree_equal(state, back)
        del back
        ctx.free(h)
    del state
    _free(device)
    k1, k2 = dma.write_rows.launches - w0, dma.read_rows.launches - r0
    report["checkpoint"] = {"state_bytes": nbytes, "save_s": save_s, "load_s": load_s,
                            "save_gbps": nbytes / save_s / 1e9,
                            "load_gbps": nbytes / load_s / 1e9, "K1": k1, "K2": k2}
    if not same:
        raise AssertionError("the MoE train state came back from LOCAL_DEVICE changed")
    if check_launches and (k1, k2) != (1, 1):
        raise AssertionError(f"a LOCAL_DEVICE save and load of the MoE state took "
                             f"{k1} K1 and {k2} K2 launches, not 1 and 1")
    report["launches"] = dma.launches()

    # One remat step and one ce_block step against the plain step, each
    # from the same state on the same batch (the last from the state
    # itself); the parameters before and after the plain step wait on the
    # host, so the card holds two states at most.
    tokens = torch.from_numpy(data[steps]).to(device)
    base = {k: v.to("cpu", copy=True) for k, v in params.items()}
    p1, o1 = _clone(params, opt)
    p1, o1, plain_loss = step(p1, o1, tokens)
    plain = {k: v.to("cpu", copy=True) for k, v in p1.items()}
    del p1, o1
    _free(device)
    trades = report["trades"] = {}
    specs = train.moe_param_specs(cfg)
    for name, kw in (("remat", {"remat": True}), ("ce_block", {"ce_block": 512})):
        p2, o2 = _clone(params, opt) if name == "remat" else (params, opt)
        p2, o2, loss = train.make_moe_train_step(cfg, tx, mesh=mesh, **kw)(p2, o2, tokens)
        rel = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
        upd, _, _ = _close_leaves(p2, plain, base, mesh, specs)
        trades[name] = {"loss": float(loss), "plain_loss": float(plain_loss),
                        "loss_rel": rel, "update_rel": upd}
        if rel > 1e-3 or upd > 0.2:
            raise AssertionError(f"the {name} step strays from the plain step: "
                                 f"{trades[name]}")
        del p2, o2
        _free(device)
    del params, opt, plain, base
    if device.type == "cuda":
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    report["seconds"] = time.perf_counter() - t_phase
    return report


def mesh_of_one_card(device, cfg, batch: int, seq: int) -> dict:
    """Phase 9 (g): two steps of the dense step on ``make_mesh(1)`` against
    two of the one-device step from the same state, bit for bit (the
    caller sets ``torch.use_deterministic_algorithms``)."""
    rng = np.random.default_rng(12)
    data = [torch.from_numpy(zipf_batch(rng, cfg.vocab, batch, seq)).to(device)
            for _ in range(2)]
    p, o, tx = train.make_train_state(cfg, lr=LR, device=device, seed=1)
    a, b = _clone(p, o), _clone(p, o)
    del p, o
    one = train.make_train_step(cfg, tx)
    meshed = train.make_train_step(cfg, tx, mesh=train.make_mesh(1, device=device))
    la, lb = [], []
    for t in data:
        *a, loss_a = one(*a, t)
        *b, loss_b = meshed(*b, t)
        la.append(float(loss_a))
        lb.append(float(loss_b))
    if not _tree_equal(a, b) or la != lb:
        raise AssertionError("the step on make_mesh(1) is not the one-device step "
                             "bit for bit")
    return {"losses": la, "bit_for_bit": True}


# -- phase T: every process of the world -----------------------------------------


FAMILIES = ("dense", "moe", "gpipe", "moe_pp")


def _family_parts(name):
    """(mesh factory, state factory, step factory, token spec)."""
    return {
        "dense": (lambda n, cfg, dev: train.make_mesh(n, device=dev),
                  train.make_train_state, train.make_train_step, train.data_spec()),
        "moe": (lambda n, cfg, dev: train.make_moe_mesh(n, n_experts=cfg.n_experts,
                                                        device=dev),
                train.make_moe_train_state, train.make_moe_train_step, P(DP, None)),
        "gpipe": (lambda n, cfg, dev: train.make_pp_mesh(n, n_layers=cfg.n_layers,
                                                         device=dev),
                  train.make_pp_train_state, train.make_pp_train_step, P(DP, None)),
        "moe_pp": (lambda n, cfg, dev: train.make_pp_mesh(n, n_layers=cfg.n_layers,
                                                          device=dev),
                   train.make_moe_pp_train_state, train.make_moe_pp_train_step,
                   P(DP, None)),
    }[name]


def _flops(name, cfg, batch, seq) -> int:
    if name.startswith("moe"):
        return moe_train_flops(cfg, batch, seq)["dense_dispatch"]
    return train_flops(cfg, batch, seq)


def _cfg(d: dict):
    return (moe.MoeConfig if "n_experts" in d else llama.LlamaConfig)(**d)


def _family_run(name, size: dict, device, n: int) -> dict:
    """(a)-(d): one family at ``size`` (cfg, batch, seq, steps, step kw)."""
    cfg = _cfg(size["cfg"])
    make_mesh, make_state, make_step, spec = _family_parts(name)
    mesh = make_mesh(n, cfg, None if device.type == "cuda" else "cpu")
    t0 = time.perf_counter()
    params, opt, tx = make_state(cfg, lr=LR, mesh=mesh, seed=0)
    _sync(device)
    init_s = time.perf_counter() - t0
    step = make_step(cfg, tx, mesh=mesh, **size.get("kw", {}))
    # One batch every step: the losses fall whatever the seed.
    batches = [zipf_batch(np.random.default_rng(13), cfg.vocab, size["batch"],
                          size["seq"])] * size["steps"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = run_steps(step, params, opt, batches, mesh, spec, device,
                    flops=_flops(name, cfg, size["batch"], size["seq"]), cards=n)
    out.update(mesh=mesh.shape, layers=cfg.n_layers, batch=size["batch"],
               seq=size["seq"], init_s=init_s, kw=size.get("kw", {}),
               params_here=sum(v.numel() for v in params.values()))
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    del params, opt
    _free(device)
    return out


def _free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# (e) and (f) hold each parameter leaf's update to the reference's: the
# norm of their difference within 5 % of the norm of the reference's update.
# An elementwise bound does not hold at these widths: Adam's first updates
# are about ±lr a weight whatever the gradient's size, so a gradient that
# sums to near zero flips its update with the last bits of its summation
# order (measured on four H100s: elements off by 0.38 % of their leaf's
# largest weight, losses within 2e-7). A leaf missing a part of its
# gradient (an axis's sum, a vocab shard) moves its whole update.
UPDATE_RTOL = 5e-2


def _close_leaves(full: dict, ref: dict, base: dict, mesh, specs) -> tuple:
    """Gather every leaf (all processes) and hold it to ``ref`` (the first
    process's host copy), the update from ``base`` by :data:`UPDATE_RTOL`.
    Returns the largest update difference, the largest elementwise |Δ| over
    its leaf's largest value, and the leaves out of bounds."""
    worst_upd, worst_el, bad = 0.0, 0.0, []
    for k in specs:
        whole = gather(full[k], mesh, specs[k])
        if _rank() == 0:
            w = whole.float()
            r = ref[k].to(w.device).float()
            b = base[k].to(w.device).float()
            step = (r - b).norm()
            upd = float((w - r).norm() / step) if step > 0 else float((w - r).norm())
            el = float((w - r).abs().max() / r.abs().max().clamp(min=1e-30))
            worst_upd, worst_el = max(worst_upd, upd), max(worst_el, el)
            if upd > UPDATE_RTOL:
                bad.append(k)
        del whole
    return worst_upd, worst_el, bad


def _against_one_card(name, size: dict, device, n: int, keep: bool = False):
    """(e): this family at ``size`` on the world's mesh against the one-device
    step on the first process: 2 steps, losses within rtol 1e-4, every
    gathered parameter leaf's update within :data:`UPDATE_RTOL` of the
    one-device step's. Returns the report (and the sharded state with
    ``keep``)."""
    cfg = _cfg(size["cfg"])
    make_mesh, make_state, make_step, spec = _family_parts(name)
    kw = dict(size.get("kw", {}))
    dev_arg = None if device.type == "cuda" else "cpu"
    rng = np.random.default_rng(14)
    batches = [zipf_batch(rng, cfg.vocab, size["batch"], size["seq"]) for _ in range(2)]
    mesh = make_mesh(n, cfg, dev_arg)  # every process makes its groups
    ref = ref_losses = base = None
    if _rank() == 0:
        # The one-device step: dense and moe as they are; a pipeline family
        # on a mesh of one, its microbatches the mesh's dp times (each routes
        # the rows one dp shard's microbatch holds there).
        if name in ("dense", "gpipe"):
            p, o, tx = train.make_train_state(cfg, lr=LR, device=device, seed=0)
            step = train.make_train_step(cfg, tx)
        elif name == "moe":
            p, o, tx = train.make_moe_train_state(cfg, lr=LR, device=device, seed=0)
            step = train.make_moe_train_step(cfg, tx)
        else:
            m1 = train.make_pp_mesh(1, device=dev_arg)
            p, o, tx = train.make_moe_pp_train_state(cfg, lr=LR, mesh=m1, seed=0)
            step = train.make_moe_pp_train_step(
                cfg, tx, mesh=m1,
                microbatches=kw.get("microbatches", 2) * mesh.axis_size(DP))
        base = {k: v.to("cpu", copy=True) for k, v in p.items()}
        ref_losses = []
        for b in batches:
            p, o, loss = step(p, o, torch.from_numpy(b).to(device))
            ref_losses.append(float(loss))
        ref = {k: v.cpu() for k, v in p.items()}
        del p, o, step
        _free(device)
    if dist.is_initialized():
        dist.barrier()
    p, o, tx = make_state(cfg, lr=LR, mesh=mesh, seed=0)
    step = make_step(cfg, tx, mesh=mesh, **kw)
    losses = []
    for b in batches:
        p, o, loss = step(p, o, train.shard_batch(b, mesh, spec).to(device))
        losses.append(float(loss))
    specs = {"dense": train.param_specs, "moe": train.moe_param_specs,
             "gpipe": train.pp_param_specs, "moe_pp": train.moe_pp_param_specs}[name](cfg)
    upd, el, bad = _close_leaves(p, ref, base, mesh, specs)
    out = {"mesh": mesh.shape, "layers": cfg.n_layers, "losses": losses}
    if _rank() == 0:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        out.update(one_card_losses=ref_losses, loss_rel=rel, update_rel=upd,
                   max_elementwise_rel=el, leaves_out=bad)
        if rel > 1e-4 or bad:
            raise AssertionError(f"(e) {name}: the sharded step strays from the "
                                 f"one-device step: {out}")
    del ref, base
    if keep:
        return out, (cfg, mesh, specs, p, o, tx, batches)
    del p, o
    _free(device)
    return out, None


def _resume_elsewhere(kept, device, n: int) -> dict:
    """(f): the MoE state of (e) saved whole to LOCAL_DEVICE on the first
    process (one K1 launch there), one step taken on its mesh from it, then
    restored by ``load_sharded`` on ``make_moe_mesh(n)`` (one K2 launch):
    every restored leaf equal to the saved one bit for bit, and one step
    there within (e)'s tolerance of the step on the old mesh."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.models import checkpoint as ck

    cfg, mesh, specs, p, o, tx, batches = kept
    state = {"params": p, "opt": o}
    shardings = train.state_shardings(mesh, specs)
    like = ck.full_like(state, shardings)
    nbytes = ck.checkpoint_nbytes(like)
    ctx = None
    if _rank() == 0:
        ctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=1 << 20,
                                         device_arena_bytes=nbytes + (1 << 20)),
                           device=device)
    w0, r0 = dma.write_rows.launches, dma.read_rows.launches
    t0 = time.perf_counter()
    h = ck.save_sharded(ctx, state, shardings, ocm.OcmKind.LOCAL_DEVICE)
    _sync(device)
    save_s = time.perf_counter() - t0
    k1 = dma.write_rows.launches - w0
    # What was saved, whole, on the first process's host.
    saved = {}
    from oncilla_tpu_torch.models.checkpoint import _walk

    for (key, leaf), (_, ns) in zip(_walk(state), _walk(shardings)):
        whole = gather(leaf, ns.mesh, ns.spec)
        if _rank() == 0:
            saved[key] = whole.cpu()
        del whole
    tokens = batches[-1]
    step_old = train.make_moe_train_step(cfg, tx, mesh=mesh)
    p, o, loss_old = step_old(p, o, train.shard_batch(tokens, mesh, P(DP, None)).to(device))
    old_after = {}
    for k in specs:
        whole = gather(p[k], mesh, specs[k])
        if _rank() == 0:
            old_after[k] = whole.cpu()
    del p, o, state, kept
    _free(device)

    mesh2 = train.make_moe_mesh(n, device=None if device.type == "cuda" else "cpu")
    sh2 = train.state_shardings(mesh2, specs)
    t0 = time.perf_counter()
    back = ck.load_sharded(ctx, h, like, sh2, src=0)
    _sync(device)
    load_s = time.perf_counter() - t0
    k2 = dma.read_rows.launches - r0
    exact = True
    for (key, leaf), (_, ns) in zip(_walk(back), _walk(sh2)):
        whole = gather(leaf, ns.mesh, ns.spec)
        if _rank() == 0:
            exact &= bool(torch.equal(whole.cpu(), saved[key]))
        del whole
    step_new = train.make_moe_train_step(cfg, tx, mesh=mesh2)
    p2, o2, loss_new = step_new(back["params"], back["opt"],
                                train.shard_batch(tokens, mesh2, P(DP, None)).to(device))
    before = {k: saved[f"['params']/[{k!r}]"] for k in specs} if _rank() == 0 else None
    del saved
    upd, el, bad = _close_leaves(p2, old_after, before, mesh2, specs)
    out = {"old_mesh": mesh.shape, "new_mesh": mesh2.shape, "state_bytes": nbytes,
           "save_s": save_s, "load_s": load_s, "K1": k1, "K2": k2,
           "bit_for_bit": exact, "loss_old_mesh": float(loss_old),
           "loss_new_mesh": float(loss_new)}
    if _rank() == 0:
        out.update(update_rel=upd, max_elementwise_rel=el, leaves_out=bad)
        rel = abs(float(loss_new) - float(loss_old)) / abs(float(loss_old))
        out["loss_rel"] = rel
        launches_ok = device.type != "cuda" or (k1, k2) == (1, 1)
        if not exact or rel > 1e-4 or bad or not launches_ok:
            raise AssertionError(f"(f) the resume on another mesh: {out}")
        ctx.free(h)
        ctx.tini()
    del back, p2, o2
    _free(device)
    return out


def _note(msg: str) -> None:
    """A progress line in this process's log (``spawn`` shows it when the
    phase fails)."""
    print(f"[phase T rank {_rank()}] {msg}", flush=True)


def phase_t(sizes: dict, device: str = "cuda") -> dict:
    """Phase T on this process (module docstring). ``sizes``: {"families":
    {name: size}, "one_card": {name: size}} where a size is {"cfg": config
    fields, "batch", "seq", "steps", "kw"}. Returns the first process's
    report (the others return their own losses and timings)."""
    from oncilla_tpu_torch.examples import multihost_train

    n = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    t_all = time.perf_counter()
    report = {"world": n, "device": (torch.cuda.get_device_name(dev)
                                     if dev.type == "cuda" else "cpu")}
    seconds = report["seconds_by"] = {}
    for name, size in sizes["families"].items():
        t0 = time.perf_counter()
        report[name] = r = _family_run(name, size, dev, n)
        seconds[name] = time.perf_counter() - t0
        _note(f"{name} {seconds[name]:.1f} s: step {r['step_ms_median']:.2f} ms, "
              f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']}, bytes "
              f"{r['collective_bytes_per_step']}, peak {r.get('peak_memory_gb')} GB")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kept = None
    one = report["one_card"] = {}
    for name, size in sizes["one_card"].items():
        t0 = time.perf_counter()
        one[name], k = _against_one_card(name, size, dev, n, keep=name == "moe")
        kept = k or kept
        seconds[f"one_card_{name}"] = time.perf_counter() - t0
        _note(f"(e) {name} {seconds[f'one_card_{name}']:.1f} s: {one[name]}")
    t0 = time.perf_counter()
    report["resume"] = _resume_elsewhere(kept, dev, n)
    seconds["resume"] = time.perf_counter() - t0
    _note(f"(f) {seconds['resume']:.1f} s")
    t0 = time.perf_counter()
    report["multihost"] = multihost_train.worker(device)
    seconds["multihost"] = time.perf_counter() - t0
    report["seconds"] = time.perf_counter() - t_all
    return report


def phase_t_sizes(full: bool = True) -> dict:
    """Phase T's sizes: the card's (``full``), or a tiny rehearsal's for the
    CPU."""
    if not full:
        dense = dataclasses.asdict(llama.LlamaConfig.tiny())
        dense4 = dict(dense, n_layers=4)
        m = dataclasses.asdict(moe.MoeConfig.tiny())
        m4 = dict(m, n_experts=4, n_layers=4)
        fam = {"dense": dict(cfg=dense, batch=1, seq=64, steps=3, kw={"remat": True}),
               "moe": dict(cfg=m4, batch=4, seq=32, steps=3),
               "gpipe": dict(cfg=dense4, batch=4, seq=32, steps=3,
                             kw={"microbatches": 4}),
               "moe_pp": dict(cfg=m4, batch=4, seq=32, steps=3,
                              kw={"microbatches": 4})}
        one = {"dense": dict(cfg=dense, batch=1, seq=64),
               "gpipe": dict(cfg=dict(dense, n_layers=2), batch=4, seq=16,
                             kw={"microbatches": 2}),
               "moe_pp": dict(cfg=dict(m, n_layers=2), batch=4, seq=16,
                              kw={"microbatches": 2}),
               "moe": dict(cfg=dict(m4, n_layers=1), batch=1, seq=64)}
        return {"families": fam, "one_card": one}
    l8 = dataclasses.asdict(llama.LlamaConfig.llama3_8b())
    mx = dataclasses.asdict(moe.MoeConfig.mixtral_8x7b())
    fam = {"dense": dict(cfg=l8, batch=1, seq=4096, steps=5, kw={"remat": True}),
           "moe": dict(cfg=dict(mx, n_layers=8), batch=4, seq=1024, steps=5),
           "gpipe": dict(cfg=l8, batch=4, seq=1024, steps=5, kw={"microbatches": 4}),
           "moe_pp": dict(cfg=dict(mx, n_layers=8), batch=4, seq=1024, steps=5,
                          kw={"microbatches": 4})}
    f32 = {"dtype": "float32", "n_layers": 2}
    one = {"dense": dict(cfg=dict(l8, **f32), batch=1, seq=512),
           "gpipe": dict(cfg=dict(l8, **f32), batch=4, seq=128, kw={"microbatches": 2}),
           "moe_pp": dict(cfg=dict(mx, **f32), batch=4, seq=128, kw={"microbatches": 2}),
           "moe": dict(cfg=dict(mx, dtype="float32", n_layers=1), batch=1, seq=512)}
    return {"families": fam, "one_card": one}
