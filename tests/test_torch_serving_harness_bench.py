"""The port's serving harness (``oncilla_tpu_torch.serving.__main__``) on
the CPU: ``run_bench``'s keys against the JAX package's ``run_bench`` and
chip_smoke's phase 8e (``phase_harness``) rehearsed on the tiny model. The
pieces' own comparisons with the JAX harness are in
``test_torch_serving_harness.py`` and ``test_torch_serving_harness_chaos.py``.
"""

import copy

import torch

from oncilla_tpu.serving import __main__ as jh
from oncilla_tpu_torch.serving import __main__ as ph
from test_torch_serving_harness import _keys, _quiet_host  # noqa: F401 (autouse)


def test_run_bench_keys_equal_jax(monkeypatch):
    """The port's ``run_bench`` on the CPU against JAX's ``run_bench``
    assembling the same pieces (the port's, recorded as the port's bench
    made them; the pieces' own keys equal JAX's, as
    test_torch_serving_harness.py and the chaos file hold): equal keys at
    every level, apart from the port's
    ``launches`` (the copy kernels' counts of the harness's process)."""
    made = {}
    real_sweep = ph.run_batched_sweep
    # The sweep at three tenants and two batch sizes (its cells' keys are
    # held against JAX's by test_run_batched_sweep_keys_equal_jax).
    monkeypatch.setattr(ph, "run_batched_sweep", lambda seed, **k: real_sweep(
        seed, tenants=3, new_tokens=4, sizes=(1, 2), **k))
    for name in ("run_pair", "run_batched_sweep", "run_chaos", "run_warmboot"):
        def record(*a, _real=getattr(ph, name), _name=name, **k):
            made[_name] = _real(*a, **k)
            return copy.deepcopy(made[_name])
        monkeypatch.setattr(ph, name, record)
    got = ph.run_bench(device="cpu")
    for name, result in made.items():
        monkeypatch.setattr(jh, name, lambda *a, _r=result, **k: copy.deepcopy(_r))
    want = jh.run_bench()
    assert set(got["launches"]) >= {"write_rows", "read_rows"}
    del got["launches"]
    assert _keys(got) == _keys(want)
    assert got["chaos"]["byte_exact"] and got["warmboot"]["byte_exact"]


def test_phase_8e_on_the_cpu():
    """``chip_smoke.phase_harness`` on the tiny model: the paired cells'
    checks on three in-process daemons, the harness's ``--smoke`` as a
    process (``--device cpu``) and GUPS over a handle, every check but the
    launch counts (no kernels on the CPU)."""
    import chip_smoke
    from oncilla_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    r = chip_smoke.phase_harness(torch.device("cpu"), cfg, params,
                                 gups_words=(1 << 10,),
                                 gups_kw={"batch": 256, "steps": 4},
                                 check_launches=False)
    sh, ns = r["cells"]["shared"], r["cells"]["noshare"]
    assert sh["prefix"]["hits"] > 0 and sh["prefix"]["cow"] > 0
    assert r["remote_bytes_shared_noshare"][0] < r["remote_bytes_shared_noshare"][1]
    assert r["drained_ranks"] == [0, 1, 2]
    assert r["shared_vs_noshare"] == "bits"  # float32 on the CPU
    assert r["smoke"]["rc"] == 0 and set(r["smoke"]["launches"]) >= {"write_rows"}
    assert r["gups"]["1024"]["table_sum"] == r["gups"]["1024"]["updates"]
    assert ns["hot_io"]["put"] > 0
