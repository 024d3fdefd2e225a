"""Phase 8f of ``chip_smoke.py`` (the serving path observed) rehearsed on
the CPU at a tiny size: 8e (a)'s two cells decoded again with the
journal, the flight recorder, the SLO watcher and ``capture_trace`` on, and
every check of the phase but those that need the card (the kernels' launch
counts and their events on the profiler's timeline, K1's host issue time).
The tiny cell decodes in well under a second, so the SLO watcher scrapes
every 20 ms here (0.5 s on the card) to see its counters rise. Of the
operator's CLIs, (h) runs one here (``fabric --smoke``);
``test_torch_smokes.py`` runs them all. Torch keeps to one thread, as for
phase 8e's rehearsal (``test_torch_serving_harness._quiet_host``).
"""

import torch

from test_torch_serving_harness import _quiet_host  # noqa: F401 (autouse)


def test_phase_8f_on_the_cpu():
    import chip_smoke
    from oncilla_tpu_torch.models import llama
    from oncilla_tpu_torch.obs import flightrec, journal
    from oncilla_tpu_torch.utils import debug

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    h = chip_smoke.phase_harness(torch.device("cpu"), cfg, params,
                                 gups_words=(1 << 10,),
                                 gups_kw={"batch": 256, "steps": 4},
                                 check_launches=False)
    r = chip_smoke.phase_observed(torch.device("cpu"), cfg, params,
                                  ref=h.pop("observe_ref"),
                                  clis=(("fabric", "--smoke"),),
                                  slo_interval_s=0.02, check_launches=False)
    assert {c["vs_unobserved"] for c in r["cells"].values()} == {"bits"}
    assert r["slo"]["evaluations"] >= 3 and r["slo"]["history"]["errors"] == 0
    assert r["slo"]["verdicts"]["serving_tokens"]["active"]
    assert r["export"]["tracks"] >= 3 and r["export"]["flows"] >= 1
    assert "serve_batch_step" in r["export"]["span_names"]
    assert r["critpath"]["rc"] == 0
    assert r["profiler"]["ocm_ranges"].get("ocm:put", 0) > 0
    assert r["cli"]["table_rc"] == 0 and r["cli"]["prom_rc"] == 0
    assert r["clis"]["fabric --smoke"]["rc"] == 0
    assert r["drained_ranks"] == [0, 1, 2]
    # Everything the phase turned on is off again.
    assert not journal.enabled() and flightrec.segment_dir() is None
    assert debug._ANNOTATION_CLS is None
