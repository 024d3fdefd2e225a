"""Captures through a local binding of a binder, as kv_paging does."""

import functools

from . import hooks
from .steps import token_step


def decode_page(params, graphs, xs, cfg):
    step = functools.partial(token_step, mlp=hooks.scaled_mlp)
    return [graphs.run(step, (x,)) for x in xs]


class Decoder:
    def step(self, x):
        return x.item()  # NOT a finding: a method the capture never sees


def ok_unrelated(graphs, step):
    return step
