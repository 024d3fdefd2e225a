"""The plain reference: the published decoder's forward pass in float32,
TF32 off, with no cache, no paging and no batching. It imports nothing of
the system under test and takes nothing it made: only the benchmark's
seeded weights and token ids.

- Mistral-7B (``model_type`` ``mistral``): pre-norm blocks, RMSNorm,
  rotary embedding on interleaved pairs as complex rotations (the
  published reference implementation's form), grouped-query attention with
  a causal sliding window of ``sliding_window`` keys (key j is seen by query
  i when i - window < j <= i), SwiGLU feed-forward.
- Mixtral-8x7B (``model_type`` ``mixtral``): the same attention; the
  feed-forward is a router (softmax over ``num_local_experts``), the top
  ``num_experts_per_tok`` experts of each token weighted by their
  probabilities renormalised over the chosen, each expert a SwiGLU. No
  token is ever dropped.

``precision`` "float8" is the control: every weight and every matmul
input rounded to float8 e4m3 (a scale per output channel, per token), the
arithmetic in float32, as an fp8 path would serve the model.
"""

from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 matmuls without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def to_e4m3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Weights:
    """float32 views of one layer's weights, made when asked for."""

    def __init__(self, params: dict, precision: str):
        self.params = params
        self.fp8 = precision == "float8"

    def get(self, name: str, *index) -> torch.Tensor:
        w = self.params[name]
        for i in index:
            w = w[i]
        w = w.float()
        if self.fp8 and w.ndim == 2 and name != "embed":
            w = to_e4m3(w, 0)  # weights are (in, out): a scale an output
        return w


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    return (to_e4m3(x, -1) if fp8 else x) @ w


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rotate(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (S, heads, hd) at positions 0..S-1: each
    interleaved pair (x[2i], x[2i+1]) as a complex number turned by
    pos * theta^(-2i/hd)."""
    S, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float64) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float64)[:, None] * inv
    rot = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    xc = torch.view_as_complex(x.reshape(S, -1, hd // 2, 2).contiguous())
    return torch.view_as_real(xc * rot[:, None, :]).reshape(x.shape)


def attention(q, k, v, window, block: int = 1024):
    """Causal grouped-query attention. q (S, H, hd), k/v (S, KV, hd);
    queries in blocks of ``block`` rows."""
    S, H, hd = q.shape
    KV = k.shape[1]
    rep = H // KV
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    j = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        i = torch.arange(a, b, device=q.device)[:, None]
        seen = j[None, :] <= i
        if window is not None:
            seen &= j[None, :] > i - window
        s = q[a:b].transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(hd)
        s = s.masked_fill(~seen, float("-inf"))
        out[a:b] = (torch.softmax(s, -1) @ v).transpose(0, 1)
    return out


def _swiglu(h, wg, wu, wd, fp8):
    return _mm(torch.nn.functional.silu(_mm(h, wg, fp8)) * _mm(h, wu, fp8),
               wd, fp8)


def ffn(h, W: Weights, cfg: dict, layer: int, margins=None):
    if cfg.get("num_local_experts"):
        return moe_ffn(h, W, cfg, layer, margins)
    return _swiglu(h, W.get("w_gate", layer), W.get("w_up", layer),
                   W.get("w_down", layer), W.fp8)


def moe_ffn(h, W: Weights, cfg: dict, layer: int, margins=None):
    """Top-k routing as published: softmax over all experts, the k largest
    renormalised to sum to one, every chosen expert applied in full.
    ``margins`` (a list) collects each token's gap between its k-th and
    (k+1)-th expert probability."""
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ W.params["w_router"][layer].float(), -1)
    if margins is not None:
        srt = probs.topk(k + 1, dim=-1).values
        margins.append(srt[:, k - 1] - srt[:, k])
    top, idx = probs.topk(k, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(E):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        out = _swiglu(h[rows], W.get("w_gate_e", layer, e),
                      W.get("w_up_e", layer, e), W.get("w_down_e", layer, e),
                      W.fp8)
        y.index_add_(0, rows, out * top[rows, slot][:, None])
    return y


def logits_at(params: dict, cfg: dict, ids: list[int], wanted: list[int],
              precision: str = "float32", margins=None) -> torch.Tensor:
    """float32 logits (len(wanted), vocab) of the sequence ``ids`` at the
    positions ``wanted``; ``margins`` as :func:`moe_ffn`'s, one entry a
    layer."""
    dev = params["embed"].device
    W = Weights(params, precision)
    D, H, KV = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    hd, eps = D // H, float(cfg["rms_norm_eps"])
    theta, window = float(cfg["rope_theta"]), cfg.get("sliding_window")
    with torch.no_grad(), exact_fp32():
        t = torch.tensor(ids, device=dev)
        x = params["embed"][t].float()
        S = x.shape[0]
        for i in range(cfg["num_hidden_layers"]):
            h = rms_norm(x, params["ln_attn"][i].float(), eps)
            q = rotate(_mm(h, W.get("wq", i), W.fp8).view(S, H, hd), theta)
            k = rotate(_mm(h, W.get("wk", i), W.fp8).view(S, KV, hd), theta)
            v = _mm(h, W.get("wv", i), W.fp8).view(S, KV, hd)
            a = attention(q, k, v, window).reshape(S, D)
            x = x + _mm(a, W.get("wo", i), W.fp8)
            h = rms_norm(x, params["ln_mlp"][i].float(), eps)
            x = x + ffn(h, W, cfg, i, margins)
        h = rms_norm(x[torch.tensor(wanted, device=dev)],
                     params["ln_out"].float(), eps)
        return _mm(h, W.get("lm_head"), W.fp8)
