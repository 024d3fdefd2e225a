"""The port's joiner (``oncilla_tpu_torch/elastic/join.py``:
``join_cluster`` and ``leave_cluster``), held to the JAX package's own
joiner tests, and the elastic smoke's join -> rebalance -> leave cycle held
to the JAX package's on the same seed.

Source: ``tests/test_elastic.py``, the three tests that call
``join_cluster``. Each is imported from it and collected here as a case; an
autouse fixture points the names the source bound at the port:
``join_cluster`` and ``leave_cluster`` are the port's, ``local_cluster`` is
``test_torch_slo.port_cluster`` (the port's in-process daemons and
clients), ``OcmConfig`` and ``OcmKind`` the port's types. So the joiner,
the daemons it joins and the client that reads through the migration are
all the port's. (``test_torch_daemon_ref_elastic.py`` runs the same three
with the JAX joiner and client against the port's daemons.) Nothing in
``oncilla_tpu/`` or the JAX tests changes.
"""

import pytest

import test_elastic as src
from oncilla_tpu.elastic import __main__ as jelastic_main
from oncilla_tpu_torch.core.kinds import OcmKind as TKind
from oncilla_tpu_torch.elastic import __main__ as telastic_main
from oncilla_tpu_torch.elastic import join as tjoin
from oncilla_tpu_torch.utils.config import OcmConfig as TConfig
from test_torch_daemon import export_ref
from test_torch_slo import port_cluster

RUN = [
    "test_join_cluster_serves_and_leave_drains",
    "test_rebalance_spreads_onto_joiner_and_ledger_drains",
    "test_join_auto_rebalance_config_knob",
]

export_ref(globals(), src, RUN)


@pytest.fixture(autouse=True)
def _port_joiner(request, monkeypatch):
    if request.function.__module__ != src.__name__:
        return
    for name, value in (("join_cluster", tjoin.join_cluster),
                        ("leave_cluster", tjoin.leave_cluster),
                        ("local_cluster", port_cluster),
                        ("OcmConfig", TConfig), ("OcmKind", TKind)):
        monkeypatch.setattr(src, name, value)


def test_package_exports_the_joiner():
    import oncilla_tpu_torch.elastic as telastic

    assert telastic.join_cluster is tjoin.join_cluster
    assert telastic.leave_cluster is tjoin.leave_cluster
    assert telastic.__all__ == ["Rebalancer", "join_cluster", "leave_cluster"]


def test_cycle_result_equals_jax():
    """The smoke's cycle on seed 1234: the rebalance after the join moves
    the same extents, the leave drains the same number, and the epoch and
    membership end where the JAX package's do."""
    want = jelastic_main.run_cycle(1234)
    got = telastic_main.run_cycle(1234)
    assert got == want == {"rebalanced": 5, "drained": 2, "epoch": 2,
                           "members": 2}
