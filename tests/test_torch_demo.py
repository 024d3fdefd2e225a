"""The port's walkthrough (``oncilla_tpu_torch.examples.demo``) against the
JAX package's ``examples/demo.py``: the same calls, in process, on the
same seeds. ``examples/`` is read, never imported (importing it would
reconfigure the JAX platform of this process).

Tolerances: the losses to rtol 1e-4 — ``LlamaConfig.tiny()`` is float32,
the JAX steps run sharded on the 8-device CPU mesh (dp, tp, sp) = (2, 2,
2) and the port's on a mesh of one, so sums round in other orders at
float32's rounding, and Adam's first ±lr update can flip a leaf whose gradient
sums to near zero, which moves the next loss by far less than 1e-4; the
last logits to atol 1e-4 — the decode starts from the JAX side's trained
weights on both sides, so a flipped leaf cannot show there, and the
float32 decode differs by summation order only. Bytes, ranks and pages
are held exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oncilla_tpu as jocm
from oncilla_tpu import OcmKind as JaxKind
from oncilla_tpu_torch import OcmDeviceError
from oncilla_tpu_torch.examples import demo
from oncilla_tpu_torch.models import llama as port_llama

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_model_and_paged_decode():
    """Section 3 of the JAX demo (``examples/demo.py:84-115``), with the
    initial and the trained weights kept as numpy arrays."""
    from oncilla_tpu.models import llama, train
    from oncilla_tpu.models.kv_paging import BucketedPagedDecoder

    cfg = llama.LlamaConfig.tiny()
    mesh = train.make_mesh()  # uses every visible device
    params, opt_state, tx = train.make_train_state(
        jax.random.key(0), cfg, mesh, lr=1e-2
    )
    init = {k: np.array(v) for k, v in params.items()}
    step = train.make_train_step(cfg, mesh, tx)
    tokens = jax.device_put(
        train.sample_batch(np.random.default_rng(2), cfg, 4, 32),
        jax.sharding.NamedSharding(mesh, train.data_spec()),
    )
    losses = []
    for i in range(3):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    trained = {k: np.array(v) for k, v in params.items()}

    with jocm.ocm_init(jocm.OcmConfig(
        host_arena_bytes=16 << 20, device_arena_bytes=4 << 20,
    )) as ctx:
        dec = BucketedPagedDecoder(
            params, cfg, ctx, batch=1, page_tokens=8,
            kind=JaxKind.LOCAL_HOST, dtype="float32",
        )
        ids = np.random.default_rng(3).integers(
            0, cfg.vocab, 24, dtype=np.int32
        )
        logits = None
        for t in ids:
            logits = dec.step(jnp.asarray([t]))
        pages = len(dec.cache.pages)
        dec.close()
    return {"mesh": dict(mesh.shape), "init": init, "trained": trained,
            "losses": losses, "pages": pages, "logits": np.asarray(logits)}


def test_main_on_the_cpu(capsys):
    """``main(["--device", "cpu"])`` prints the JAX demo's three sections
    and "demo complete" (the port's seeded weights)."""
    assert demo.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:7] == [
        "== 1. Local allocations (ocm_test.c test 1/2 shape) ==",
        "   put/get 1024 KiB on LOCAL_DEVICE: roundtrip ok",
        "   device->host ocm_copy: ok",
        "== 2. Two-node cluster: remote DRAM + training checkpoint ==",
        "   alloc placed on rank 1 (origin 0; is_remote=True)",
        "   one-sided put/get across the (loopback) DCN fabric: ok",
        "   checkpoint (68 KiB) saved to rank 1 DRAM and restored: ok",
    ]
    assert lines[7] == "== 3. Flagship model: train step + OCM-paged decode =="
    assert lines[8].startswith(
        "   3 sharded train steps on mesh {'dp': 1, 'tp': 1, 'sp': 1}: loss=")
    loss = float(lines[8].rsplit("=", 1)[1])
    assert np.isfinite(loss) and loss < np.log(256)  # below a uniform guess
    assert lines[9:] == [
        "   24 decode steps, KV paged through OCM (3 pages shipped): "
        "logits (1, 256)",
        "demo complete",
    ]


def test_main_needs_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(OcmDeviceError):
        demo.main([])
    with pytest.raises(OcmDeviceError):
        demo.main(["--device", "cuda"])


def test_local_memory_bytes_equal_the_jax_demos(capsys):
    port = demo.local_memory(CPU)
    with jocm.ocm_init(jocm.OcmConfig(
        host_arena_bytes=32 << 20, device_arena_bytes=32 << 20,
    )) as ctx:
        h = ctx.alloc(1 << 20, JaxKind.LOCAL_DEVICE)
        data = np.random.default_rng(0).integers(
            0, 256, 1 << 20, dtype=np.uint8
        )
        ctx.put(h, data)
        back = np.asarray(ctx.get(h))
        h2 = ctx.alloc(1 << 20, JaxKind.LOCAL_HOST)
        ctx.copy(h2, h)
        copied = np.asarray(ctx.get(h2))
        kib, kind = h.nbytes >> 10, h.kind.name
        ctx.free(h), ctx.free(h2)
    assert (port["kib"], port["kind"]) == (kib, kind) == (1024, "LOCAL_DEVICE")
    assert np.array_equal(port["bytes"], back)
    assert np.array_equal(port["copied"], copied)


def test_cluster_and_checkpoint_equal_the_jax_demos(capsys):
    from oncilla_tpu.models import checkpoint as ckpt
    from oncilla_tpu.runtime.cluster import local_cluster

    port = demo.cluster_and_checkpoint(CPU)
    cfg = jocm.OcmConfig(
        host_arena_bytes=16 << 20, device_arena_bytes=1 << 20,
        chunk_bytes=256 << 10, heartbeat_s=0.5, lease_s=30.0,
    )
    with local_cluster(2, config=cfg) as cluster:
        ctx = cluster.context(0)
        h = ctx.alloc(2 << 20, JaxKind.REMOTE_HOST)
        payload = np.arange(2 << 20, dtype=np.uint8)
        ctx.put(h, payload)
        back = np.asarray(ctx.get(h))
        rank, is_remote = h.rank, h.is_remote
        ctx.free(h)
        state = {
            "w": jnp.asarray(np.random.default_rng(1).standard_normal(
                (256, 128)), jnp.bfloat16),
            "step": jnp.int32(1234),
        }
        hc = ckpt.save(ctx, state, JaxKind.REMOTE_HOST)
        restored = ckpt.load(ctx, hc, like=state)
        ckpt_bytes, ckpt_rank = hc.nbytes, hc.rank
        ctx.free(hc)
    assert (port["rank"], port["is_remote"]) == (rank, is_remote) == (1, True)
    assert np.array_equal(port["bytes"], back)
    # The port's region is the JAX package's, then zeros to a multiple of
    # 4096 (one copy kernel launch a LOCAL_DEVICE save): 65920 B -> 68 KiB.
    assert port["checkpoint_kib"] == -(-ckpt_bytes // 4096) * 4096 >> 10
    assert port["checkpoint_rank"] == ckpt_rank == 1
    want_w = np.asarray(restored["w"]).view(np.uint16)
    got_w = port["restored"]["w"].view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got_w, want_w)
    assert int(port["restored"]["step"]) == int(restored["step"]) == 1234


def test_model_and_paged_decode_equal_the_jax_demos(
        jax_model_and_paged_decode, capsys):
    ref = jax_model_and_paged_decode
    port = demo.model_and_paged_decode(
        CPU,
        params=port_llama.params_from_jax(ref["init"], CPU),
        decode_params=port_llama.params_from_jax(ref["trained"], CPU),
    )
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
    assert port["losses"][-1] < port["losses"][0]
    assert port["pages"] == ref["pages"] == 3
    np.testing.assert_allclose(port["logits"].numpy(), ref["logits"],
                               atol=1e-4, rtol=0)
    assert port["mesh"] == {"dp": 1, "tp": 1, "sp": 1}
    assert ref["mesh"] == {"dp": 2, "tp": 2, "sp": 2}


def test_phase_d_on_the_cpu():
    """``chip_smoke.py``'s phase D rehearsed: on CPU tensors every wrapper
    takes its plain version, so no kernel counts a launch."""
    import chip_smoke

    r = chip_smoke.phase_demo(CPU, expect={})
    assert r["lines"][0].startswith("== 1.") and r["lines"][-1] == "demo complete"
    assert set(r["launches"]) >= set(chip_smoke.DEMO_LAUNCHES)
    assert not any(r["launches"].values())
    with pytest.raises(AssertionError, match="predicted"):
        chip_smoke.phase_demo(CPU)  # the card's counts are not the CPU's
