"""Seeded violations of ``graph-host-call`` that only a resolution
across modules finds: the captured steps are defined in ``steps`` and
``hooks`` and handed to the capture in ``runner`` and ``engine``, through
a local binding, a binder, a method's parameter and an import.

Scanned explicitly by tests/test_torch_analysis.py (the whole package at
once) — excluded from default ``python -m oncilla_tpu_torch.analysis``
walks. Four findings, each on a line marked ``# FINDING``; the
``ok_*`` functions and the ``step`` methods stay silent.
"""
