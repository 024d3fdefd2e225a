"""The port's ring attention (``parallel/ring_attention.py``) held against
dense attention and the JAX package's ring, output and gradients, from the
same numpy inputs: the port in 4 gloo processes along ``sp``, the JAX ring
on a 4-device ``node`` mesh (``tests/test_ring_attention.py`` whole, with
GQA and the sliding window added). Tolerance: 1e-5 absolute in float32
(the online softmax merges four blocks where the dense softmax takes one
pass).

Then the dense family's forward on (dp, tp, sp) meshes of 4 processes with
the ring (or the K/V gathered over sp) against the JAX package's
unsharded forward from the same weights (``test_model.py``'s
ring-vs-dense tests: float32 within 2e-4, bf16 within 5e-2, the window
spanning chunk boundaries).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from oncilla_tpu.models import llama as jl
from oncilla_tpu.models import train as jt
from oncilla_tpu.parallel.mesh import node_mesh
from oncilla_tpu.parallel.ring_attention import ring_attention
from oncilla_tpu_torch.parallel.launch import spawn
from oncilla_tpu_torch.parallel.ring_attention import ring_attention_shard

CASES = [
    dict(name="causal", causal=True, kv=4),
    dict(name="full", causal=False, kv=4),
    dict(name="causal_gqa", causal=True, kv=2),
    dict(name="window_gqa", causal=True, kv=2, window=10),
]
B, H, S, D = 2, 4, 32, 16


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    arr = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(c, q=arr(B, H, S, D), k=arr(B, c["kv"], S, D),
                v=arr(B, c["kv"], S, D), dout=arr(B, H, S, D))


INPUTS = [_inputs(c, i) for i, c in enumerate(CASES)]


@pytest.fixture(scope="module")
def world():
    fwd = []
    for i, c in enumerate(FWD):
        cfg, params, tokens = _fwd_case(c, i)
        fwd.append(dict(c, cfg=dataclasses.asdict(cfg), tokens=tokens,
                        params={k: np.asarray(v) for k, v in params.items()}))
    return spawn("_torch_dist:ring_and_forwards", 4, args=(INPUTS, fwd),
                 device="cpu", timeout=120)[0]


@pytest.fixture(scope="module")
def port(world):
    return world["ring"]


def _mask(c):
    if not c["causal"]:
        return None
    return jl.causal_mask(S, S, c.get("window"))


def _dense(c, q, k, v):
    return jl.grouped_attention(q, k, v, _mask(c))


def _jax_ring(c, q, k, v):
    return ring_attention(q, k, v, node_mesh(jax.devices()[:4]), axis_name="node",
                          causal=c["causal"], window=c.get("window"))


def _value_and_grads(fn, c):
    @jax.jit
    def both(q, k, v, dout):
        out, vjp = jax.vjp(lambda q, k, v: fn(c, q, k, v), q, k, v)
        return out, vjp(dout)

    out, grads = both(*(jnp.asarray(c[k]) for k in ("q", "k", "v", "dout")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c["name"] for c in CASES])
@pytest.mark.parametrize("ref", ["dense", "jax_ring"])
def test_ring_matches(port, i, ref):
    c = INPUTS[i]
    want, want_g = _value_and_grads(_dense if ref == "dense" else _jax_ring, c)
    np.testing.assert_allclose(port[i]["o"], want, atol=1e-5, rtol=0)
    for name, got, w in zip("qkv", port[i]["grads"], want_g):
        np.testing.assert_allclose(got, w, atol=1e-5, rtol=0, err_msg=f"d{name}")


def test_the_window_really_bites(port):
    assert not np.allclose(port[3]["o"], port[2]["o"])


def test_ring_window_non_causal_rejected():
    with pytest.raises(ValueError, match="causal"):
        ring_attention_shard(None, None, None, axis_name="sp", causal=False,
                             window=4)


CFG = jl.LlamaConfig.tiny()
FWD = [
    dict(name="ring", shape=(1, 2, 2), dtype="float32", window=None, tol=2e-4),
    dict(name="ring_dp", shape=(2, 1, 2), dtype="float32", window=None, tol=2e-4),
    dict(name="gathered", shape=(1, 2, 2), dtype="float32", window=None, tol=2e-4,
         ring=False),
    dict(name="ring_bf16", shape=(1, 2, 2), dtype="bfloat16", window=None, tol=5e-2),
    dict(name="ring_window", shape=(1, 2, 2), dtype="float32", window=10, tol=2e-4),
]


def _fwd_case(c, seed):
    cfg = dataclasses.replace(CFG, dtype=c["dtype"], window=c["window"])
    params = jl.init_params(jax.random.key(seed), cfg)
    tokens = np.asarray(jt.sample_batch(np.random.default_rng(seed), cfg, 2, 64))
    return cfg, params, tokens


@pytest.fixture(scope="module")
def forwards(world):
    return world["forwards"]


@pytest.mark.parametrize("i", range(len(FWD)), ids=[c["name"] for c in FWD])
def test_sharded_forward_matches_the_dense_forward(forwards, i):
    c = FWD[i]
    cfg, params, tokens = _fwd_case(c, i)
    dense = np.asarray(jl.forward(params, jnp.asarray(tokens), cfg)).astype(np.float32)
    np.testing.assert_allclose(forwards[i], dense, atol=c["tol"], rtol=c["tol"])
    if c["window"]:
        full = np.asarray(jl.forward(params, jnp.asarray(tokens),
                                     dataclasses.replace(cfg, window=None)))
        assert not np.allclose(dense, full)
