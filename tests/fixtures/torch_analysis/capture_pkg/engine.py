"""Captures through a method's parameter, as the serving engine does."""

import time

from capture_pkg import steps


class Engine:
    def __init__(self, graphs, params, cfg):
        self.graphs, self.params, self.cfg = graphs, params, cfg

    def _run(self, fn, args):
        return self.graphs.run(fn, args)

    def decode(self, xs):
        return self._run(steps.batch_step, (xs,))

    def timed(self, x):
        return self._run(timed_step, (x,))

    def step(self, x):
        return x.numpy()  # NOT a finding: a method the capture never sees


def timed_step(params, x, cfg):
    t0 = time.perf_counter()  # FINDING: a host clock at capture
    return x, t0
