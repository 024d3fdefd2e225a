"""Quality of service, the port's copies of ``oncilla_tpu/qos``: the
priority classes the serving engine seats by, the wire profile a client
declares at CONNECT, the daemon's admission and eviction accounting
(:class:`.policy.QosManager`) and load-aware placement (:mod:`.loadaware`).
"""
