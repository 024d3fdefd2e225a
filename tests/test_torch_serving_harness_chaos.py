"""The serving harness's chaos and warm-boot legs on the CPU, the port's
(``oncilla_tpu_torch.serving.__main__``) against the JAX package's:
``run_chaos`` equal to JAX's (owner killed, chaos log, tokens); one pass of
the warm-boot scenario (``_warmboot_scenario``) against the same arms built
from the JAX package's modules as its ``run_warmboot`` builds them (tokens
of every arm, prefix reuse, persisted extents, chaos log), replayed
identically; and ``run_warmboot``'s TTFT assertion, which still raises when
the warm arm's mean TTFT is not below the cold arm's."""

import os
import tempfile

import pytest

from oncilla_tpu.serving import __main__ as jh
from oncilla_tpu_torch.serving import __main__ as ph
from test_torch_serving_harness import _quiet_host  # noqa: F401 (autouse)

WARMBOOT = {"tenants": 3, "shared_tokens": 20, "suffix_tokens": 4}
WARMBOOT_CELLS = {"new_tokens": 8, "page_tokens": 8, "hot": 12, "warm": 8,
                  "prefetch_workers": 2}


def test_run_chaos_equals_jax():
    got = ph.run_chaos(1234, new_tokens=16, hot=2, warm=2, device="cpu")
    want = jh.run_chaos(1234, new_tokens=16, hot=2, warm=2)
    assert got == want
    assert got["byte_exact"] and got["chaos_log"] == [[2, "drop", -1], [4, "kill", 1]]


def _jax_scenario(seed: int) -> dict:
    """The JAX package's warm-boot arms (run_warmboot's ``scenario``,
    serving/__main__.py:546-577) on the JAX package's modules."""
    from oncilla_tpu.analysis import alloctrace
    from oncilla_tpu.persist import FrozenStore
    from oncilla_tpu.resilience.chaos import ChaosController, ChaosSchedule
    from oncilla_tpu.runtime.cluster import local_cluster

    cfg, params = jh._tiny_model()
    prompts = jh._prompts(seed, vocab=cfg.vocab, **WARMBOOT)

    def cell(cl, name, frozen_dir):
        return jh._run_cell(
            cl, cfg, params, share=True, prompts=prompts, name=name,
            frozen_backend=FrozenStore(frozen_dir) if frozen_dir else None,
            **WARMBOOT_CELLS)

    alloctrace.reset()
    with tempfile.TemporaryDirectory() as tmp:
        seed_dir = os.path.join(tmp, "seeded")
        with local_cluster(3, config=jh._cluster_cfg()) as cl:
            ref = cell(cl, "serve-warmboot-ref", None)
            seeded = cell(cl, "serve-warmboot-seed", seed_dir)
            persisted = sum(1 for k in FrozenStore(seed_dir).keys()
                            if k.startswith("prefix-"))
            controller = ChaosController(ChaosSchedule(seed=seed), cl.entries,
                                         restart_fn=cl.restart)
            for r in range(len(cl.daemons)):
                controller.force("restart", r)
            coldarm = cell(cl, "serve-warmboot-cold", None)
            cell(cl, "serve-warmboot-jitwarm", seed_dir)  # discarded
            warmarm = cell(cl, "serve-warmboot-warm", seed_dir)
            drained = jh._assert_drained(cl)
    return {"ref": ref, "seeded": seeded, "cold": coldarm, "warm": warmarm,
            "persisted": persisted, "log": list(controller.log),
            "drained": drained}


def _port_scenario(seed: int) -> dict:
    cfg, params = ph._tiny_model(ph.resolve_device("cpu"))
    prompts = ph._prompts(seed, vocab=cfg.vocab, **WARMBOOT)
    return ph._warmboot_scenario(seed, cfg, params, prompts, **WARMBOOT_CELLS)


def test_warmboot_scenario_equals_jax_and_replays():
    got = _port_scenario(1234)
    want = _jax_scenario(1234)
    arms = ("ref", "seeded", "cold", "warm")
    for arm in arms:
        assert got[arm]["outputs"] == want[arm]["outputs"], arm
        assert got[arm]["outputs"] == got["ref"]["outputs"]  # byte-exact
        assert got[arm]["prefix_tokens_reused"] == want[arm]["prefix_tokens_reused"]
    # The warm boot reuses more of the prompts than the cold restart.
    assert got["warm"]["prefix_tokens_reused"] > got["cold"]["prefix_tokens_reused"]
    assert got["persisted"] == want["persisted"] > 0
    assert got["log"] == want["log"] == [(-1, "restart", r) for r in range(3)]
    assert got["drained"] == want["drained"] == [0, 1, 2]
    again = _port_scenario(1234)
    assert again["log"] == got["log"]
    assert {a: again[a]["outputs"] for a in arms} == {a: got[a]["outputs"] for a in arms}


def test_run_warmboot_ttft_assertion_still_raises(monkeypatch):
    """The assertion stands as the JAX package wrote it: a warm arm whose
    mean TTFT is not below the cold arm's fails ``run_warmboot``."""
    real = ph._warmboot_scenario

    def slow_warm(*a, **k):
        r = real(*a, **k)
        cold = r["cold"]["ttft"]
        r["warm"]["ttft"] = {**r["warm"]["ttft"], "count": cold["count"],
                             "sum_s": cold["sum_s"]}  # warm == cold
        return r

    monkeypatch.setattr(ph, "_warmboot_scenario", slow_warm)
    with pytest.raises(AssertionError, match="did not cut mean TTFT"):
        ph.run_warmboot(1234, device="cpu")
