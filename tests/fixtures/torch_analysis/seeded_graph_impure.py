"""Seeded violation: host-side calls inside a CUDA-graph capture
(``graph-host-call``, the port's counterpart of ``jit-host-call``).

Scanned explicitly by tests/test_torch_analysis.py — excluded from
default ``python -m oncilla_tpu_torch.analysis`` walks. Six findings in
three functions; the ``ok_*`` functions stay silent.
"""

import time

import numpy as np
import torch

from oncilla_tpu_torch.models.graphs import CapturedStep


def captured_block(graph, x):
    with torch.cuda.graph(graph):
        y = x * 2
        scale = y.sum().item()     # FINDING: a device value read on the host
        torch.cuda.synchronize()   # FINDING: a sync inside the capture
        return y * scale


def handed_step(x):
    host = x.cpu()                 # FINDING: runs once, at capture
    print("captured", host)        # FINDING: runs once, at capture
    return x + 1


def make_step(x):
    return CapturedStep(handed_step, [x])   # marks `handed_step` captured


def graphed_decode(graphs, args):
    return graphs.run(graphed_body, args)   # marks `graphed_body` captured


def graphed_body(params, tokens, cfg):
    t0 = time.perf_counter()       # FINDING: a host clock at capture
    ids = np.asarray(tokens)       # FINDING: host numpy on a device value
    return params["embed"][ids], t0


def ok_pure_step(x):
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        return torch.tanh(x) * 2.0  # NOT a finding


def ok_host_helper(x):
    return np.asarray(x.cpu()).tolist()  # NOT a finding: not captured
