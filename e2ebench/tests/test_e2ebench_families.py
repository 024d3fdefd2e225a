"""Model families (``e2ebench/families/``): the configuration's
``model_type`` finds the module that reads its keys. The two families of
the benchmark's configurations draw the same weights, give the same
reference logits and the same per-layer readings as the harness did before
families existed (the pinned values below were read there), and a family
joins as one new module: a test-only one with keys of another shape runs a
cell through the paged decoder to ``correct``."""

import hashlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from e2ebench import families, run, weights, yardstick
from e2ebench.metrics import decode_mfu, step_hbm_share
from e2ebench.reference import decoder
from e2ebench.tests.tiny import TINY, spec_of

HERE = Path(__file__).resolve().parents[1]
CONFIGS = ("mixtral-8x7b-v0.1.l8", "mistral-7b-v0.1")


def _config(name: str, tiny: bool) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return {**cfg, **TINY} if tiny else cfg


# Read before families existed: weights.make(tiny, 2**31 + 77, "cpu"), a
# sha256 over every leaf's name and bytes in draw order; the reference's
# logits at positions 20-23 of _IDS, their first four columns; the leaves'
# names and shapes at the published widths.
PINNED = {
    "mixtral-8x7b-v0.1.l8": {
        "sha": "3673f654ff5251acf7b2ad92d78be704fb62d127a41aafb582965e965281e570",
        "logits": [-1.198157, -1.486773, 1.224338, 0.817268, 0.722277, 0.050734,
                   0.449325, 0.996086, -0.909455, 0.407808, -0.464237, -0.831334,
                   -1.597562, -0.637606, 0.706011, 0.388476],
        "leaves": [("embed", (32000, 4096)), ("wq", (8, 4096, 4096)),
                   ("wk", (8, 4096, 1024)), ("wv", (8, 4096, 1024)),
                   ("wo", (8, 4096, 4096)), ("ln_attn", (8, 4096)),
                   ("ln_mlp", (8, 4096)), ("ln_out", (4096,)),
                   ("lm_head", (4096, 32000)), ("w_router", (8, 4096, 8)),
                   ("w_gate_e", (8, 8, 4096, 14336)),
                   ("w_up_e", (8, 8, 4096, 14336)),
                   ("w_down_e", (8, 8, 14336, 4096))],
    },
    "mistral-7b-v0.1": {
        "sha": "bcad3df883c0eac9e36855922050a46de2137fe48184aa2e04ca94bc2652f3f4",
        "logits": [-0.326022, -1.548039, 1.16957, 0.303285, -0.112351, 0.978949,
                   0.227, 0.079956, -0.455902, -0.391763, -0.67159, 0.449105,
                   -1.604529, -0.41448, -0.03326, 0.266471],
        "leaves": [("embed", (32000, 4096)), ("wq", (32, 4096, 4096)),
                   ("wk", (32, 4096, 1024)), ("wv", (32, 4096, 1024)),
                   ("wo", (32, 4096, 4096)), ("ln_attn", (32, 4096)),
                   ("ln_mlp", (32, 4096)), ("ln_out", (4096,)),
                   ("lm_head", (4096, 32000)), ("w_gate", (32, 4096, 14336)),
                   ("w_up", (32, 4096, 14336)), ("w_down", (32, 14336, 4096))],
    },
}
SEED = 2**31 + 77
_IDS = [int(x) for x in torch.randint(
    0, 256, (24,), generator=torch.Generator().manual_seed(3))]


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "published"])
@pytest.mark.parametrize("name", CONFIGS)
def test_the_family_gives_the_sizes_and_leaves_of_before(name, tiny):
    cfg = _config(name, tiny)
    fam = families.of(cfg)
    assert fam.__name__ == f"e2ebench.families.{cfg['model_type']}"
    assert fam.dims(cfg) == weights.dims(cfg)
    assert fam.leaves(cfg) == weights.leaves(cfg)
    if not tiny:
        assert [(k, tuple(s)) for k, (s, _) in fam.leaves(cfg).items()] == \
            PINNED[name]["leaves"]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_weights_drawn_are_those_of_before(name):
    params = weights.make(_config(name, True), SEED, "cpu")
    h = hashlib.sha256()
    for k, t in params.items():
        h.update(k.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == PINNED[name]["sha"]


@pytest.mark.parametrize("name", CONFIGS)
def test_the_reference_gives_the_logits_of_before(name):
    cfg = _config(name, True)
    fam = families.of(cfg)
    assert fam.logits_at is decoder.logits_at
    lg = fam.logits_at(weights.make(cfg, SEED, "cpu"), cfg, _IDS, [20, 21, 22, 23])
    got = lg[:, :4].flatten()
    torch.testing.assert_close(got, torch.tensor(PINNED[name]["logits"]),
                               rtol=0, atol=1e-5)


def _readings():
    cfg = _config("mixtral-8x7b-v0.1.l8", False)
    fam = families.of(cfg)
    return run.Readings(
        d=fam.dims(cfg), family=fam,
        computed=[(1152 + 128 * i, 128) for i in range(9)] * 32,
        window_s=49.25, peak_flops=989e12, peak_hbm=3.35e12,
        trace={"busy_s": 5.4},
        pages=[(10.0 + i, 1152 + 128 * i, 128) for i in range(9)],
        stretch=(10.5, 14.5), batch=32)


def test_the_readers_read_what_they_read_before():
    r = _readings()
    assert r.family.flops is yardstick.flops
    assert r.family.step_bytes is yardstick.moe_step_bytes
    # read with the readers as they were before families
    assert decode_mfu.read(r) == 0.5144540101235089
    assert step_hbm_share.read(r) == 71.0234086187728


def test_a_family_without_step_bytes_reads_no_hbm_share():
    r = _readings()
    r.family = families.of({"model_type": "mistral"})
    assert not hasattr(r.family, "step_bytes")
    assert step_hbm_share.read(r) is None
    assert decode_mfu.read(r) > 0


def test_an_unknown_model_type_fails_before_any_weight_is_drawn(monkeypatch):
    def drawn(*a, **kw):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(weights, "generator", drawn)
    spec = spec_of("mixtral8x7b.decode_long", model_type="no_such_family")
    with pytest.raises(SystemExit) as e:
        run.run("mixtral8x7b.decode_long", 5, 1.0, False, device="cpu", spec=spec)
    assert str(HERE / "families" / "no_such_family.py") in str(e.value)
    with pytest.raises(SystemExit):
        weights.make(spec["cfg"], 5, "cpu")
    with pytest.raises(SystemExit, match="names no model family"):
        families.of({"model_type": "mixtral.x"})


# A family whose configuration has keys of another shape, as newer MoE
# configurations write them: the expert count as ``num_experts``, the
# expert width apart from the dense one, the rope base inside
# ``rope_parameters``; no ``rope_theta``, ``num_local_experts`` or
# ``sliding_window``. Routing is Mixtral's (softmax, top-k renormalised).
PLUG = "plugin_moe"
PLUG_CFG = {
    "model_type": PLUG, "torch_dtype": "float32", "vocab_size": 256,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_hidden_layers": 2, "intermediate_size": 192,
    "moe_intermediate_size": 96, "num_experts": 8, "num_experts_per_tok": 2,
    "norm_topk_prob": True,
    "rope_parameters": {"rope_type": "default", "rope_theta": 500000.0},
    "rms_norm_eps": 1e-6, "max_position_embeddings": 4096,
    "capacity_factor": 4.0,
}


def _plugin_family(made: list) -> types.ModuleType:
    """The module a new file ``families/plugin_moe.py`` would hold."""

    def as_mixtral(cfg):
        keep = ("vocab_size", "hidden_size", "num_attention_heads",
                "num_key_value_heads", "num_hidden_layers",
                "num_experts_per_tok", "rms_norm_eps", "torch_dtype")
        return {**{k: cfg[k] for k in keep},
                "intermediate_size": cfg["moe_intermediate_size"],
                "num_local_experts": cfg["num_experts"],
                "rope_theta": cfg["rope_parameters"]["rope_theta"],
                "sliding_window": None}

    def port_config(cfg):
        from oncilla_tpu_torch.models.moe import MoeConfig

        d = m.dims(cfg)
        pcfg = MoeConfig(vocab=d["vocab"], dim=d["dim"], n_layers=d["layers"],
                         n_heads=d["heads"], n_kv_heads=d["kv_heads"],
                         ffn_hidden=d["ffn"],
                         max_seq=cfg["max_position_embeddings"],
                         rope_theta=d["rope_theta"], norm_eps=d["eps"],
                         dtype=cfg["torch_dtype"], window=None,
                         n_experts=d["experts"], top_k=d["top_k"],
                         capacity_factor=float(cfg["capacity_factor"]))
        made.append(pcfg)
        return pcfg

    def paged_hooks(pcfg):
        from oncilla_tpu_torch.models import moe

        return moe.paged_hooks(pcfg)

    m = types.ModuleType(f"e2ebench.families.{PLUG}")
    m.dims = lambda cfg: weights.dims(as_mixtral(cfg))
    m.leaves = lambda cfg: weights.leaves(as_mixtral(cfg))
    m.logits_at = lambda params, cfg, *a, **kw: decoder.logits_at(
        params, as_mixtral(cfg), *a, **kw)
    m.flops = yardstick.flops
    m.step_bytes = yardstick.moe_step_bytes
    m.port_config, m.paged_hooks = port_config, paged_hooks
    return m


def test_a_family_joins_as_one_module(monkeypatch):
    assert not (HERE / "families" / f"{PLUG}.py").exists()
    made = []
    monkeypatch.setitem(sys.modules, f"e2ebench.families.{PLUG}",
                        _plugin_family(made))
    spec = spec_of("mixtral8x7b.decode_long")
    spec["cell"] = {**spec["cell"], "name": "plugin.decode_long",
                    "config": PLUG}
    spec["cfg"] = dict(PLUG_CFG)
    params = weights.make(spec["cfg"], SEED, "cpu")
    assert params["w_gate_e"].shape == (2, 8, 64, 96)
    out = run.run("plugin.decode_long", SEED, 2.5, False, device="cpu",
                  spec=spec)
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["mean_gap"]["value"] < 1e-4
    assert made and made[0].ffn_hidden == 96 and made[0].n_experts == 8
