"""Workers of the port's multi-process CPU tests (``test_torch_mesh``,
``_collectives``, ``_ring_attention``, ``_train_sharded``, ``_moe_train``,
``_pipeline``, ``_checkpoint_sharded``, ``_multihost``).

Each function runs in every process of a gloo world that
``oncilla_tpu_torch.parallel.launch.spawn`` starts (``file://``
rendezvous in a directory of its own), and returns picklable results
(numpy arrays, floats) that the test compares with the JAX package in the
pytest process. This module imports torch and the port only: a spawned
process never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from oncilla_tpu_torch.models import llama, moe, train
from oncilla_tpu_torch.parallel import collectives as col
from oncilla_tpu_torch.parallel.mesh import DP, PP, SP, TP, Mesh, P, gather, shard

LR = 3e-4
MU = {None: None, "bfloat16": torch.bfloat16}


def _rank() -> int:
    return dist.get_rank()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tree_np(d: dict) -> dict:
    return {k: _np(v) for k, v in d.items()}


# -- mesh and collectives ------------------------------------------------------


def mesh_layout(shapes: list[dict]) -> list:
    """Each mesh's coordinates, group ranks and shard/gather round trip."""
    out = []
    for shape in shapes:
        mesh = Mesh(shape, device="cpu")
        full = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
        names = list(shape)
        spec = P(names[0], tuple(names[1:]) or None, None)
        part = shard(full, mesh, spec)
        back = gather(part, mesh, spec)
        out.append({
            "coords": dict(mesh.coords),
            "ranks": {a: mesh.ranks(a) for a in names},
            "part": _np(part), "round_trip": bool(torch.equal(back, full)),
        })
    return out


def collectives(x_global: np.ndarray) -> dict:
    """psum, copy, all_gather, ppermute and all_to_all over a 4-process
    axis ``i``: each forward and the gradient of sum(out * w). A result
    left replicated (psum) is weighed by w = 2 on every process, counted
    once; ``copy`` takes process 0's x on every process (a replicated
    input); the rest are weighed by w = rank + 1 (each process's own
    output)."""
    mesh = Mesh({"i": dist.get_world_size()}, device="cpu")
    g = mesh.group("i")
    me = mesh.axis_index("i")
    res = {}
    cases = {
        "psum": (lambda x: col.psum(x, g), me, 2.0),
        "copy": (lambda x: col.copy(x, g) * 1.0, 0, me + 1.0),
        "all_gather": (lambda x: col.all_gather(x, 0, g), me, me + 1.0),
        "ppermute": (lambda x: col.ppermute(x, mesh, "i", col.ring_perm(4)),
                     me, me + 1.0),
        "ppermute_partial": (lambda x: col.ppermute(x, mesh, "i",
                                                    [(0, 2), (1, 3)]),
                             me, me + 1.0),
        "all_to_all": (lambda x: col.all_to_all(x, 0, 1, g), me, me + 1.0),
    }
    for name, (fn, src, w) in cases.items():
        x = torch.from_numpy(x_global[src]).requires_grad_()
        y = fn(x)
        (gx,) = torch.autograd.grad((y * w).sum(), [x])
        res[name] = {"y": _np(y), "gx": _np(gx)}
    res["pmax"] = _np(col.pmax(torch.from_numpy(x_global[me]), g))
    return res


def membership_errors(base_port: int) -> dict:
    """``torch_membership``'s answers in a world of more than one process."""
    import os

    from oncilla_tpu_torch.core.errors import OcmError
    from oncilla_tpu_torch.runtime.membership import torch_membership

    out = {}
    for name, kw, env in (("no_hosts", {}, None),
                          ("wrong_count", {"hosts": ["a", "b"]}, None),
                          ("env", {}, "h0,h1,h2,h3")):
        os.environ.pop("OCM_HOSTS", None)
        if env:
            os.environ["OCM_HOSTS"] = env
        try:
            entries, rank = torch_membership(base_port, **kw)
            out[name] = ([(e.rank, e.host, e.port) for e in entries], rank)
        except OcmError as e:
            out[name] = str(e)
    os.environ.pop("OCM_HOSTS", None)
    return out


# -- ring attention ------------------------------------------------------------


def ring(cases: list[dict]) -> list:
    """Ring attention over a 4-process ``sp`` axis: each case's output and
    the gradients of sum(out * dout), gathered to full sequences."""
    mesh = Mesh({SP: dist.get_world_size()}, device="cpu")
    group = mesh.group(SP)
    out = []
    for c in cases:
        qkv = [shard(torch.from_numpy(c[k]), mesh, P(None, None, SP))
               .requires_grad_() for k in ("q", "k", "v")]
        o = llama_ring(qkv, mesh, c)
        dout = shard(torch.from_numpy(c["dout"]), mesh, P(None, None, SP))
        grads = torch.autograd.grad((o * dout).sum(), qkv)
        out.append({"o": _np(col.all_gather(o.detach(), 2, group)),
                    "grads": [_np(col.all_gather(gr, 2, group)) for gr in grads]})
    return out


def llama_ring(qkv, mesh, c):
    from oncilla_tpu_torch.parallel.ring_attention import ring_attention

    return ring_attention(*qkv, mesh, axis_name=SP, causal=c["causal"],
                          window=c.get("window"))


def forwards(cases: list[dict]) -> list:
    """The dense family's forward on a (dp, tp, sp) mesh with the ring over
    sp (or the K/V gathered), each process's logits gathered whole."""
    out = []
    for c in cases:
        cfg = llama.LlamaConfig(**c["cfg"])
        mesh = train.make_mesh(shape=c["shape"], device="cpu")
        params = train.shard_params(llama.params_from_jax(c["params"], "cpu"),
                                    mesh, train.param_specs(cfg))
        tokens = train.shard_batch(c["tokens"], mesh)
        with torch.no_grad():
            logits = llama.forward(params, tokens, cfg, mesh=mesh,
                                   seq_axis=SP if mesh.axis_size(SP) > 1 else None,
                                   ring=c.get("ring", True))
        out.append(_np(gather(logits, mesh, P(DP, SP, TP))))
    return out


# -- the dense train step ------------------------------------------------------


def dense_runs(runs: list[dict]) -> dict:
    """Each run: the sharded dense step from ``make_train_state_host(0)``
    on its mesh shape over its global batches; returns (on rank 0) the
    losses and the gathered params and Adam µ."""
    out = {}
    for r in runs:
        cfg = llama.LlamaConfig(**r.get("cfg", {})) if r.get("cfg") else \
            llama.LlamaConfig.tiny()
        mesh = train.make_mesh(shape=r["shape"], device="cpu")
        kw = dict(r.get("kw", {}))
        mu = MU[kw.pop("mu_dtype", None)]
        offload = kw.get("offload_opt", False)
        p, o, tx = train.make_train_state_host(0, cfg, lr=r.get("lr", LR),
                                               mu_dtype=mu, offload_opt=offload,
                                               mesh=mesh)
        if offload:
            kw["opt_state"] = o
        step = train.make_train_step(cfg, tx, mesh=mesh, **kw)
        losses = []
        if r.get("prefetch"):
            from oncilla_tpu_torch.utils.data import prefetch_to_mesh

            batches = prefetch_to_mesh(iter(r["batches"]), mesh, train.data_spec())
        else:
            batches = (train.shard_batch(b, mesh) for b in r["batches"])
        for tokens in batches:
            p, o, loss = step(p, o, tokens)
            losses.append(float(loss))
        res = {"losses": losses}
        if r.get("eval"):
            ev = train.make_eval_step(cfg, mesh=mesh)
            res["eval"] = train.evaluate(
                p, (train.shard_batch(b, mesh) for b in r["eval"]), ev, mesh=mesh)
        specs = train.param_specs(cfg)
        full = train.gather_params(p, mesh, specs)
        mu_full = train.gather_params(o[0].mu, mesh, specs)
        if _rank() == 0:
            res.update(params=_tree_np(full), mu=_tree_np(mu_full),
                       count=int(o[0].count))
            out[r["name"]] = res
    return out


# -- the MoE family ------------------------------------------------------------


def moe_runs(runs: list[dict]) -> dict:
    """Each run: the MoE step (or the MoE pipeline step, ``pp``) from the
    JAX package's initial params on its mesh shape; returns (on rank 0) the
    losses and the gathered params."""
    out = {}
    for r in runs:
        cfg = moe.MoeConfig(**r["cfg"])
        full0 = llama.params_from_jax(r["params"], "cpu")
        if r.get("pp"):
            mesh = train.make_pp_mesh(shape=r["shape"], device="cpu")
            specs = train.moe_pp_param_specs(cfg)
            p, o, tx = train.make_sharded_state(full0, specs, mesh, lr=r["lr"])
            step = train.make_moe_pp_train_step(cfg, tx, mesh=mesh, **r.get("kw", {}))
        else:
            mesh = train.make_moe_mesh(shape=r["shape"], device="cpu")
            specs = train.moe_param_specs(cfg)
            p, o, tx = train.make_sharded_state(full0, specs, mesh, lr=r["lr"])
            step = train.make_moe_train_step(cfg, tx, mesh=mesh, **r.get("kw", {}))
        losses = []
        for b in r["batches"]:
            p, o, loss = step(p, o, train.shard_batch(b, mesh, P(DP, None)))
            losses.append(float(loss))
        full = train.gather_params(p, mesh, specs)
        if _rank() == 0:
            out[r["name"]] = {"losses": losses, "params": _tree_np(full)}
    return out


def moe_routes(cases: list[dict]) -> list:
    """``moe.route`` of this process's rows of global router logits under a
    data-parallel split (global routing), gathered back to the global
    token order."""
    out = []
    for c in cases:
        mesh = Mesh(c["mesh"], device="cpu")
        axes = tuple(c["axes"])
        B, S = c["rows"], c["seq"]
        logits = torch.from_numpy(c["logits"]).reshape(B, S, -1)
        spec = P(*(a if a in axes else None for a in (DP, c.get("seq_axis"))))
        mine = shard(logits, mesh, spec)
        b = mine.shape[0]
        d, cmb, aux = moe.route(mine.reshape(-1, mine.shape[-1]), c["k"], c["cap"],
                                mesh=mesh, axes=axes, rows=b)
        E, C = d.shape[1:]
        shape = (b, mine.shape[1], E, C)
        d_full = gather(d.reshape(shape), mesh, spec)
        c_full = gather(cmb.reshape(shape), mesh, spec)
        out.append({"dispatch": _np(d_full).reshape(B * S, E, C),
                    "combine": _np(c_full).reshape(B * S, E, C),
                    "aux": float(aux)})
    return out


def moe_forwards(cases: list[dict]) -> list:
    """The MoE forward over a mesh with named axes (ep and the sequence
    axis), logits and aux gathered whole."""
    out = []
    for c in cases:
        cfg = moe.MoeConfig(**c["cfg"])
        mesh = Mesh(c["mesh"], device="cpu")
        specs = {k: P(*[a if a in mesh.shape else None for a in s])
                 for k, s in train.moe_param_specs(cfg).items()}
        params = train.shard_params(llama.params_from_jax(c["params"], "cpu"),
                                    mesh, specs)
        tokens = shard(torch.from_numpy(c["tokens"]), mesh,
                       P(None, c.get("seq_axis")))
        with torch.no_grad():
            logits, aux = moe.forward(params, tokens, cfg, mesh=mesh,
                                      seq_axis=c.get("seq_axis"),
                                      ep_axis=c.get("ep_axis"))
        out.append({"logits": _np(gather(logits, mesh, P(None, c.get("seq_axis"),
                                                          None))),
                    "aux": float(aux)})
    return out


def pp_stage_routes(case: dict) -> dict:
    """The dispatch each MoE pipeline stage computes for its microbatches,
    with the router logits it routed (local routing)."""
    seen = []
    real_route = moe.route

    def recording(logits, top_k, cap, **kw):
        d, c, a = real_route(logits, top_k, cap, **kw)
        seen.append((_np(logits), _np(d), _np(c), cap))
        return d, c, a

    moe.route = recording
    try:
        moe_runs([case])
    finally:
        moe.route = real_route
    return {"rank": _rank(), "seen": seen}


# -- the pipeline --------------------------------------------------------------


def _double_stage(w, x):
    for wi in w.unbind(0):
        x = 2.0 * x + wi
    return x


def pipeline_toy(w: np.ndarray, x: np.ndarray, combos: list) -> list:
    """The toy stage (x -> 2x + w a layer) through GPipe on (dp, pp)
    meshes: outputs and the gradients of sum(out ** 2), gathered."""
    from oncilla_tpu_torch.parallel.pipeline import pipeline_apply

    out = []
    for pp, mb in combos:
        n = dist.get_world_size()
        mesh = Mesh({DP: n // pp, PP: pp}, device="cpu")
        wl = shard(torch.from_numpy(w), mesh, P(PP)).requires_grad_()
        xl = shard(torch.from_numpy(x), mesh, P(DP)).requires_grad_()
        y = pipeline_apply(_double_stage, wl, xl, mesh=mesh, axis_name=PP,
                           batch_axis=DP, microbatches=mb)
        loss = col.psum((y ** 2).sum(), mesh.group(DP))
        gw, gx = torch.autograd.grad(loss, [wl, xl])
        col.all_reduce_(gw, mesh.group(DP))
        out.append({"y": _np(gather(y.detach(), mesh, P(DP))),
                    "gw": _np(gather(gw, mesh, P(PP))),
                    "gx": _np(gather(gx, mesh, P(DP)))})
    return out


def pp_forward(case: dict) -> dict:
    """The dense (or MoE) layer stack through GPipe against the plain
    forward's blocks: final hidden states and (MoE) the aux, gathered."""
    from oncilla_tpu_torch.parallel.pipeline import pipeline_apply

    is_moe = case.get("moe", False)
    cfg = (moe.MoeConfig if is_moe else llama.LlamaConfig)(**case["cfg"])
    keys = moe.MOE_LAYER_KEYS if is_moe else llama.LAYER_KEYS
    mesh = Mesh(dict(zip((DP, PP), case["shape"])), device="cpu")
    full = llama.params_from_jax(case["params"], "cpu")
    tokens = shard(torch.from_numpy(case["tokens"]), mesh, P(DP))
    blocks = {k: shard(full[k], mesh, P(PP)) for k in keys}
    with torch.no_grad():
        x0 = llama.embed(full, tokens, cfg)
        res = pipeline_apply(train.make_pp_stage_fn(cfg, moe_aux=is_moe), blocks,
                             x0, mesh=mesh, axis_name=PP, batch_axis=DP,
                             microbatches=case["mb"], with_aux=is_moe)
        x, aux = res if is_moe else (res, torch.zeros(()))
        logits = llama.final_logits(full, x, cfg)
    return {"logits": _np(gather(logits, mesh, P(DP))), "aux": float(aux)}


def pp_runs(runs: list[dict]) -> dict:
    """Each run: the GPipe step of the dense family (or the MoE family,
    ``moe``) from the JAX package's initial params on its (dp, pp) shape;
    returns (on rank 0) the losses and the gathered params."""
    res = {}
    for r in runs:
        if r.get("moe"):
            res.update(moe_runs([dict(r, pp=True)]))
            continue
        cfg = llama.LlamaConfig(**r["cfg"])
        mesh = train.make_pp_mesh(shape=r["shape"], device="cpu")
        specs = train.pp_param_specs(cfg)
        p, o, tx = train.make_sharded_state(
            llama.params_from_jax(r["params"], "cpu"), specs, mesh, lr=r["lr"])
        step = train.make_pp_train_step(cfg, tx, mesh=mesh, **r.get("kw", {}))
        losses = []
        for b in r["batches"]:
            p, o, loss = step(p, o, train.shard_batch(b, mesh, P(DP, None)))
            losses.append(float(loss))
        full = train.gather_params(p, mesh, specs)
        if _rank() == 0:
            res[r["name"]] = {"losses": losses, "params": _tree_np(full)}
    return res


def pipeline_all(w, x, combos, forwards: list[dict], runs: list[dict]) -> dict:
    """The pipeline file's spawn: the toy stage, the model stacks' forwards
    and the GPipe train steps."""
    return {"toy": pipeline_toy(w, x, combos),
            "forward": [pp_forward(c) for c in forwards],
            "runs": pp_runs(runs)}


# -- checkpoints ---------------------------------------------------------------


def checkpoint_resume(batches: list, shapes: list) -> dict:
    """A sharded dense state trained 2 steps on mesh ``shapes[0]``, saved
    whole (``save_sharded``) to LOCAL_HOST on rank 0 and restored with
    ``load_sharded`` on every mesh of ``shapes`` (rank 0 reads, broadcasts):
    the restored shards against the saved state's slices bit for bit, and
    2 more steps from each restored state against 2 more on the live one."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.models import checkpoint as ck

    cfg = llama.LlamaConfig.tiny()
    mesh = train.make_mesh(shape=shapes[0], device="cpu")
    specs = train.param_specs(cfg)
    p, o, tx = train.make_train_state_host(0, cfg, lr=1e-2, mesh=mesh)
    step = train.make_train_step(cfg, tx, mesh=mesh)
    for b in batches[:2]:
        p, o, _ = step(p, o, train.shard_batch(b, mesh))
    state = {"params": p, "opt": o}
    shardings = train.state_shardings(mesh, specs)
    like = ck.full_like(state, shardings)
    whole = {"params": train.gather_params(p, mesh, specs),
             "mu": train.gather_params(o[0].mu, mesh, specs),
             "nu": train.gather_params(o[0].nu, mesh, specs)}
    ctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=64 << 20,
                                     device_arena_bytes=1 << 20), device="cpu") \
        if _rank() == 0 else None
    h = ck.save_sharded(ctx, state, shardings, ocm.OcmKind.LOCAL_HOST)
    # The live run goes on.
    for b in batches[2:]:
        p, o, loss = step(p, o, train.shard_batch(b, mesh))
    res = {"live_loss": float(loss), "resumed": {}}
    for shape in shapes:
        m2 = train.make_mesh(shape=shape, device="cpu")
        sh2 = train.state_shardings(m2, specs)
        back = ck.load_sharded(ctx, h, like, sh2, src=0)
        exact = all(
            torch.equal(back["params"][k], shard(whole["params"][k], m2, specs[k]))
            and torch.equal(back["opt"][0].mu[k], shard(whole["mu"][k], m2, specs[k]))
            and torch.equal(back["opt"][0].nu[k], shard(whole["nu"][k], m2, specs[k]))
            for k in specs)
        step2 = train.make_train_step(cfg, tx, mesh=m2)
        p2, o2 = back["params"], back["opt"]
        for b in batches[2:]:
            p2, o2, loss2 = step2(p2, o2, train.shard_batch(b, m2))
        res["resumed"][str(shape)] = {"exact": exact, "loss": float(loss2),
                                      "count": int(o2[0].count)}
    if ctx is not None:
        ctx.free(h)
        ctx.tini()
    return res


def save_async_sharded(batches: list) -> dict:
    """``save_async`` of this process's shards during training: the
    checkpoint holds the shards as they were at the call."""
    import oncilla_tpu_torch as ocm
    from oncilla_tpu_torch.models import checkpoint as ck

    cfg = llama.LlamaConfig.tiny()
    mesh = train.make_mesh(shape=(2, 2, 1), device="cpu")
    p, o, tx = train.make_train_state_host(40, cfg, lr=1e-2, mesh=mesh)
    step = train.make_train_step(cfg, tx, mesh=mesh)
    snap = {k: v.clone() for k, v in p.items()}
    ctx = ocm.ocm_init(ocm.OcmConfig(host_arena_bytes=16 << 20,
                                     device_arena_bytes=1 << 20), device="cpu")
    fut = ck.save_async(ctx, p, ocm.OcmKind.LOCAL_HOST)
    for b in batches:
        p, o, _ = step(p, o, train.shard_batch(b, mesh))
    h = fut.result(timeout=120)
    back = ck.load(ctx, h, like=snap)
    res = {"snapshot": all(torch.equal(back[k], snap[k]) for k in snap),
           "moved": not torch.equal(p["wq"], snap["wq"])}
    ctx.free(h)
    ctx.tini()
    return res


def data_feeds_step(batches: list) -> list:
    """``prefetch_to_mesh`` feeding the sharded dense step."""
    from oncilla_tpu_torch.utils.data import prefetch_to_mesh

    cfg = llama.LlamaConfig.tiny()
    mesh = train.make_mesh(device="cpu")
    p, o, tx = train.make_train_state_host(0, cfg, lr=1e-2, mesh=mesh)
    step = train.make_train_step(cfg, tx, mesh=mesh)
    losses = []
    for tokens in prefetch_to_mesh(iter(batches), mesh, train.data_spec()):
        p, o, loss = step(p, o, tokens)
        losses.append(float(loss))
    return losses


def one_card_equivalence(batches: list) -> bool:
    """A mesh of one process adds nothing: its step's state equals the
    one-device step's bit for bit."""
    cfg = llama.LlamaConfig.tiny()
    mesh = train.make_mesh(1, device="cpu")
    a = train.make_train_state_host(0, cfg, lr=1e-2, device="cpu")
    b = train.make_train_state_host(0, cfg, lr=1e-2, mesh=mesh)
    sa = train.make_train_step(cfg, a[2])
    sb = train.make_train_step(cfg, b[2], mesh=mesh)
    pa, oa, pb, ob = a[0], a[1], b[0], b[1]
    for t in batches:
        t = torch.from_numpy(t)
        pa, oa, la = sa(pa, oa, t)
        pb, ob, lb = sb(pb, ob, t)
        if not torch.equal(la, lb):
            return False
    return all(torch.equal(pa[k], pb[k]) and torch.equal(oa[0].mu[k], ob[0].mu[k])
               for k in pa)



def eight(dense: list[dict], moe_: list[dict]) -> dict:
    """The 8-process test: dense and MoE runs on (2, 2, 2) meshes."""
    out = dense_runs(dense)
    out.update(moe_runs(moe_))
    return out


# -- one world a test file: the files' workers in one spawn each ---------------


def collectives_and_membership(x_global, base_port: int) -> dict:
    return {"collectives": collectives(x_global),
            "membership": membership_errors(base_port)}


def ring_and_forwards(cases: list, fwd_cases: list) -> dict:
    return {"ring": ring(cases), "forwards": forwards(fwd_cases)}


def moe_all(runs: list, routes: list, fwd: list, pp_case: dict) -> dict:
    return {"runs": moe_runs(runs), "routes": moe_routes(routes),
            "forwards": moe_forwards(fwd), "pp": pp_stage_routes(pp_case)}


def checkpoints(batches: list, shapes: list, async_batches: list) -> dict:
    return {"resume": checkpoint_resume(batches, shapes),
            "async": save_async_sharded(async_batches)}
