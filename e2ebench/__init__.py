"""The end-to-end benchmark of oncilla_tpu_torch (``run.py``)."""
