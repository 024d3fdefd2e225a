"""The port's FROZEN tier and warm boot (``serving/tiers.py``'s fourth rung,
``serving/prefix.py``'s ``persist``/``restore``, ``serving/engine.py``'s
boot and close, ``persist/__main__.py``) held against the JAX package.

Source: ``tests/test_persist.py``. The three tests of the serving tiers'
fourth rung and the chaos ``restart`` test are imported from it and
collected here as cases; an autouse fixture points the names the source
bound at the port: ``make_store`` builds the port's ``TieredPageStore`` on
a CPU ``Ocm`` over the port's ``FrozenStore``; ``FrozenStore``, the error
classes and the ``Tier`` and ``ChaosController``/``ChaosSchedule``/``Fault``
the tests import from the JAX modules are the port's; the cluster's
daemons are the port's (``test_torch_daemon.patch_ref``). Nothing in
``oncilla_tpu/`` or the JAX tests changes.

Added here:

- the store's tier placement, occupancy, frozen keys and bytes equal the
  JAX store's over the same seeded operations, and ``io["frozen"]`` counts;
- a prefix trie persisted by either package's engine (tiny config, float32
  pages) restores in the other's: every restored page's bytes equal its
  file's, the warm engine reuses more prefix tokens than a cold one, and
  its tokens equal the cold engine's;
- ``python -m oncilla_tpu_torch.persist --smoke``'s ``smoke`` returns 0.
"""

import numpy as np
import pytest
import torch

import oncilla_tpu as jocm
import oncilla_tpu_torch as tocm
import test_persist as src
from oncilla_tpu.core import errors as jerrors
from oncilla_tpu.persist import FrozenStore as JFrozen
from oncilla_tpu.resilience import chaos as jchaos
from oncilla_tpu.serving import tiers as jtiers
from oncilla_tpu.serving.engine import Request as JRequest
from oncilla_tpu.serving.engine import ServingEngine as JEngine
from oncilla_tpu.serving.metrics import ServingStats as JStats
from oncilla_tpu.serving.prefix import PrefixCache as JPrefix
from oncilla_tpu_torch.core import errors as terrors
from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.persist import FrozenStore as TFrozen
from oncilla_tpu_torch.resilience import chaos as tchaos
from oncilla_tpu_torch.serving.engine import Request, ServingEngine
from oncilla_tpu_torch.serving.metrics import ServingStats
from oncilla_tpu_torch.serving.prefix import PrefixCache
from oncilla_tpu_torch.serving.tiers import Tier, TieredPageStore
from test_torch_daemon import export_ref, patch_ref
from test_torch_serving import shared_prompts, tiny_model  # noqa: F401 - fixtures

RUN = [
    "test_pages_spill_to_frozen_and_read_byte_exact",
    "test_referenced_shared_extent_never_frozen",
    "test_frozen_leftovers_do_not_collide_with_new_pages",
    "test_chaos_restart_action",
]

export_ref(globals(), src, RUN)


def port_make_store(tmp_path, hot=1, warm=1, **kw):
    """``test_persist.make_store`` on the port: a CPU ``Ocm``, the port's
    store and frozen store."""
    ctx = tocm.Ocm(config=tocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20), device="cpu")
    frozen = TFrozen(str(tmp_path))
    store = TieredPageStore(ctx, src.PB, hot_capacity=hot, warm_capacity=warm,
                            stats=ServingStats("test-frozen"),
                            frozen_backend=frozen, **kw)
    return ctx, store, frozen


@pytest.fixture(autouse=True)
def _port_frozen(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    patch_ref(monkeypatch, src, make_store=port_make_store, FrozenStore=TFrozen)
    for name in dir(src):
        if name.startswith("Ocm") and hasattr(terrors, name) \
                and hasattr(jerrors, name):
            monkeypatch.setattr(src, name, getattr(terrors, name))
    monkeypatch.setattr(jtiers, "Tier", Tier)
    for name in ("ChaosController", "ChaosSchedule", "Fault"):
        monkeypatch.setattr(jchaos, name, getattr(tchaos, name))


# -- the store against the JAX store ------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frozen_tier_placement_equals_jax(tmp_path, seed):
    """The same seeded allocs, reads, promotions and frees on both
    packages' four-tier stores (hot 1, warm 1, cold 2): each page in the
    same tier after every step, the same occupancy and frozen keys, the
    same bytes."""
    PB = src.PB
    rng = np.random.default_rng(seed)
    tctx = tocm.Ocm(config=tocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20), device="cpu")
    jctx = jocm.Ocm(config=jocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20))
    tfz, jfz = TFrozen(str(tmp_path / "t")), JFrozen(str(tmp_path / "j"))
    ts = TieredPageStore(tctx, PB, hot_capacity=1, warm_capacity=1,
                         stats=ServingStats("t"), frozen_backend=tfz)
    js = jtiers.TieredPageStore(jctx, PB, hot_capacity=1, warm_capacity=1,
                                stats=JStats("j"), frozen_backend=jfz)
    pages, datas = [], []
    try:
        for _ in range(60):
            op = rng.integers(0, 5) if pages else 0
            if op <= 1:
                d = rng.integers(0, 256, PB, dtype=np.uint8)
                pages.append((ts.alloc_page(d), js.alloc_page(d)))
                datas.append(d)
            else:
                i = int(rng.integers(0, len(pages)))
                tp, jp = pages[i]
                if op == 2:
                    assert ts.read_page(tp).numpy().tobytes() == \
                        np.asarray(js.read_page(jp)).tobytes() == \
                        datas[i].tobytes()
                elif op == 3:
                    ts.promote(tp)
                    js.promote(jp)
                else:
                    ts.free_page(tp)
                    js.free_page(jp)
                    del pages[i], datas[i]
            assert [tp.tier.value for tp, _ in pages] == \
                [jp.tier.value for _, jp in pages]
            assert ts.occupancy() == js.occupancy()
            assert tfz.keys() == jfz.keys()
        assert ts.io["frozen"]["put"] > 0 and ts.io["frozen"]["get"] > 0
    finally:
        ts.close()
        js.close()
        tctx.tini()
        jctx.tini()
    assert tfz.keys() == jfz.keys() == []


def test_frozen_extent_corrupt_is_refused_typed(tmp_path):
    """A FROZEN page whose file rots is refused typed (``OcmFrozenCorrupt``)
    and quarantined; a prefetch read of it then reports not-ok and a
    promotion raises, neither serving bytes."""
    from oncilla_tpu_torch.persist import OcmFrozenCorrupt
    from oncilla_tpu_torch.persist.store import _fname

    ctx, store, frozen = port_make_store(tmp_path)
    try:
        pages = [store.alloc_page(src.page_data(i)) for i in range(6)]
        cold = [p for p in pages if p.tier == Tier.FROZEN]
        assert cold
        tchaos.corrupt_file(str(tmp_path / _fname(cold[0].handle.key)),
                            offset=100)
        with pytest.raises(OcmFrozenCorrupt):
            store.read_page(cold[0])
        # Quarantined whole: later reads find no entry, typed, never bytes.
        buf = torch.zeros(src.PB, dtype=torch.uint8)
        assert store.fetch_bytes(cold[0], buf) == (cold[0].version, False)
        assert not buf.any()
        with pytest.raises(OcmError):
            store.promote(cold[0])
        assert cold[0].tier == Tier.FROZEN
    finally:
        store.close()
        ctx.tini()


# -- a prefix trie across the two packages ------------------------------------

P = 8  # tokens a page


def _port_engine(tiny_model, frozen_dir, prompts, new_tokens=6):
    _, _, cfg, params = tiny_model
    ctx = tocm.Ocm(config=tocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20), device="cpu")
    store = TieredPageStore(
        ctx, ServingEngine.page_nbytes(cfg, P), hot_capacity=3,
        warm_capacity=4, stats=ServingStats("t"),
        frozen_backend=TFrozen(frozen_dir) if frozen_dir else None)
    prefix = PrefixCache(store, P)
    eng = ServingEngine(params, cfg, store, prefix, page_tokens=P,
                        max_active=4, prefetch_workers=0, name="t",
                        batched=True)
    try:
        restored = {e.key: store.read_host(e.page).numpy().tobytes()
                    for e in prefix.extents()}
        for i, p in enumerate(prompts):
            eng.submit(Request(tenant=f"t{i}", tokens=p,
                               max_new_tokens=new_tokens))
        results = eng.run()
    finally:
        eng.close()
        store.close()
        ctx.tini()
    return ({r.tenant: list(r.out_tokens) for r in results}, restored,
            sum(r.prefix_tokens_reused for r in results))


def _jax_engine(tiny_model, frozen_dir, prompts, new_tokens=6):
    cfg, params, _, _ = tiny_model
    ctx = jocm.Ocm(config=jocm.OcmConfig(
        host_arena_bytes=1 << 20, device_arena_bytes=1 << 20))
    store = jtiers.TieredPageStore(
        ctx, JEngine.page_nbytes(cfg, P), hot_capacity=3, warm_capacity=4,
        stats=JStats("j"),
        frozen_backend=JFrozen(frozen_dir) if frozen_dir else None)
    prefix = JPrefix(store, P)
    eng = JEngine(params, cfg, store, prefix, page_tokens=P, max_active=4,
                  prefetch_workers=0, name="j", batched=True)
    try:
        restored = {e.key: np.asarray(store.read_page(e.page)).tobytes()
                    for e in prefix.extents()}
        for i, p in enumerate(prompts):
            eng.submit(JRequest(tenant=f"t{i}", tokens=p,
                                max_new_tokens=new_tokens))
        results = eng.run()
    finally:
        eng.close()
        store.close()
        ctx.tini()
    return ({r.tenant: list(r.out_tokens) for r in results}, restored,
            sum(r.prefix_tokens_reused for r in results))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trie_persisted_by_one_package_restores_in_the_other(
        tmp_path, tiny_model, shared_prompts, writer):  # noqa: F811
    """Engine close persists the trie (``prefix-<chainhash>`` files); the
    other package's engine restores it at boot: the same keys, each page's
    bytes its file's; then it decodes the same prompts with more prefix
    tokens reused than a cold engine and the cold engine's tokens."""
    write, read = ((_port_engine, _jax_engine) if writer == "port"
                   else (_jax_engine, _port_engine))
    seed = str(tmp_path / "seeded")
    seeded, _, _ = write(tiny_model, seed, shared_prompts)
    files = TFrozen(seed)
    persisted = {k[len("prefix-"):]: files.read_bytes(k)
                 for k in files.keys() if k.startswith("prefix-")}
    assert persisted and files.lost == []
    assert {k: JFrozen(seed).read_bytes(f"prefix-{k}")
            for k in persisted} == persisted
    cold, none, cold_reused = read(tiny_model, None, shared_prompts)
    assert none == {}
    warm, restored, warm_reused = read(tiny_model, seed, shared_prompts)
    assert restored == persisted
    assert warm_reused > cold_reused
    assert warm == cold == seeded


def test_persist_smoke_returns_zero():
    """``python -m oncilla_tpu_torch.persist --smoke``: the store leg and
    the two audited demote -> chaos restart -> warm boot -> promote runs."""
    from oncilla_tpu_torch.persist.__main__ import smoke

    assert smoke(7) == 0


def test_phase_8d_on_the_cpu():
    """``chip_smoke.phase_warmboot`` at a tiny size: every check but the
    launch counts (no kernels on the CPU) and the TTFT comparison, which on
    a tiny model is unsteady (ROADMAP Queue C: the JAX package's own
    ``run_warmboot`` fails it on the CPU in 2 of 3 runs)."""
    import chip_smoke
    from oncilla_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    r = chip_smoke.phase_warmboot(
        torch.device("cpu"), cfg, params, page_tokens=8,
        prompts={"n": 6, "shared": 32, "suffix": 4}, new_tokens=6,
        tiers=(3, 2), hold_ttft=False, check_launches=False)
    arms = r["arms"]
    assert arms["warm"]["restored"] == arms["warm"]["persisted_before"] > 0
    assert arms["seeded"]["io"]["frozen"]["get"] > 0
    assert arms["warm"]["out"] == arms["cold"]["out"] == arms["ref"]["out"]
    assert r["persist_smoke"]["rc"] == 0
