"""Tiny widths of each cell for the CPU rehearsals: the cell's own
harness, adapters and reference, at sizes a test holds.

``CHAT`` rehearses the chat adapter (``adapters/serving_engine.py``) that
no cell of ``BENCHMARK.json`` drives yet: the chat cells come back, as
data, once the serving engine's CUDA graphs fit the card (PERF.md §7).
Its cell is written here whole, with the metrics those cells report."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            num_hidden_layers=2, intermediate_size=128, vocab_size=256,
            torch_dtype="float32")

CHAT_MIX = dict(adapter="serving_engine", clients=4, system_tokens=24,
                user_tokens={"median": 6, "sigma": 0.5, "min": 3, "max": 12},
                new_tokens={"median": 8, "sigma": 0.5, "min": 4, "max": 16},
                max_turns=3, max_context=96,
                engine={"page_tokens": 4, "store_dtype": "float32",
                        "max_active": 4, "max_batch": 4,
                        "prefetch_workers": 2, "hot_pages": 16,
                        "warm_pages": 64, "cold_pages": 8192},
                warmup={"min_finished": 4, "quiet_ticks": 3,
                        "max_seconds": 20},
                trace={"start_s": 0.1, "seconds": 0.2},
                check={"sample_tokens": 40, "min_tokens": 20})

DECODE = dict(batch=4, prompt_tokens=16, page_tokens=8, max_context=256,
              trace={"start_s": 0.1, "seconds": 0.2},
              check={"sample_tokens": 40, "min_tokens": 20})

CHAT = "rehearsal.chat_tiered"


def _chat_spec() -> dict:
    def metric(name, unit):
        return {"name": name, "unit": unit}

    return {
        "cell": {"name": CHAT, "config": "mistral-7b-v0.1",
                 "traffic": "chat_sessions", "chips": 1},
        "cfg": json.loads((HERE / "configs" / "mistral-7b-v0.1.json").read_text()),
        "mix": dict(CHAT_MIX),
        "limits": {"mean_gap": 0.0025},
        "end_to_end": [metric("decode_tok_s", "tokens/s"),
                       metric("ttft_p90_s", "s"), metric("itl_p95_ms", "ms"),
                       metric("setup_s", "s")],
        "per_layer": [metric("serve_step_ms", "ms"),
                      metric("prefill_chunk_ms", "ms"),
                      metric("kv_hit_ratio", "%"),
                      metric("stall_ms_per_step", "ms"),
                      metric("decode_mfu", "%"),
                      metric("kv_copy_roofline", "%"),
                      metric("device_idle_share", "%")],
    }


def spec_of(workload: str, **cfg) -> dict:
    """The cell ``workload`` (a cell of BENCHMARK.json, or ``CHAT``) at tiny
    widths, with ``cfg`` over them."""
    from e2ebench import run

    spec = _chat_spec() if workload == CHAT else run.load_cell(workload)
    small = CHAT_MIX if workload == CHAT else DECODE
    spec["cfg"] = {**spec["cfg"], **TINY, **cfg}
    spec["mix"] = {**spec["mix"], **small}
    return spec


def mix_of(workload: str) -> dict:
    return spec_of(workload)["mix"]


def run_tiny(workload: str, seed: int = 12345678901, seconds: float = 2.5,
             trace: bool = False, cfg: dict | None = None, **kw):
    from e2ebench import run

    return run.run(workload, seed, seconds, trace, device="cpu",
                   spec=spec_of(workload, **(cfg or {})), **kw)
