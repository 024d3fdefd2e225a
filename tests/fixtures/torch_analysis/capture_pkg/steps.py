"""Step functions: captured only through what ``runner`` and ``engine``
hand to the capture helper."""

import numpy as np


def token_step(params, x, cfg, mlp=None):
    h = helper(x)
    if mlp is not None:
        h = mlp(h)
    return h * params["w"]


def helper(x):
    return x + np.asarray(x.shape).sum()  # FINDING: called by a captured step


def batch_step(params, xs, cfg):
    return [x.cpu() for x in xs]  # FINDING: handed through a method's parameter


def ok_eager(x):
    return x.tolist()  # NOT a finding: never captured
