"""Dense Llama training on one device: the single-device part of
``oncilla_tpu/models/train.py``.

A step is ``loss_fn`` (autograd for the gradients) followed by the in-place
AdamW of :mod:`oncilla_tpu_torch.models.optim`, the counterpart of the JAX
step's ``value_and_grad`` -> ``tx.update`` -> ``apply_updates`` with its
params and state donated. ``offload_opt`` keeps Adam's moments in pinned
host memory (the JAX package's ``memory_kind="pinned_host"`` placement):
the step brings each leaf's moments to the card and sends them back.

The sharded meshes (``make_mesh``, ``param_specs``, ``shard_params``,
``data_spec``), the MoE and pipeline steps wait for the sharded slice of
the port (ROADMAP A 3).
"""

from __future__ import annotations

import numpy as np
import torch

from oncilla_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
    init_params_host,
    loss_fn,
)
from oncilla_tpu_torch.models.optim import adamw
from oncilla_tpu_torch.utils.platform import resolve_device


def _state(params: dict, lr: float, offload_opt: bool, mu_dtype):
    tx = adamw(lr, weight_decay=0.01, mu_dtype=mu_dtype)
    return params, tx.init(params, host=offload_opt), tx


def make_train_state(cfg: LlamaConfig, generator: torch.Generator | None = None,
                     lr: float = 3e-4, offload_opt: bool = False,
                     mu_dtype: torch.dtype | None = None, device=None,
                     seed: int = 0):
    """(params, opt_state, tx): parameters drawn on ``device`` from
    ``generator`` (one seeded with ``seed`` when not given) and the JAX
    package's optimizer, ``adamw(lr, weight_decay=0.01, mu_dtype)``."""
    params = init_params(cfg, generator, device, seed)
    return _state(params, lr, offload_opt, mu_dtype)


def make_train_state_host(seed: int, cfg: LlamaConfig, lr: float = 3e-4,
                          offload_opt: bool = False,
                          mu_dtype: torch.dtype | None = None, device=None):
    """As :func:`make_train_state`, from the JAX package's numpy draws
    (:func:`~oncilla_tpu_torch.models.llama.init_params_host`): the same
    initial weights as its ``make_train_state_host``."""
    params = init_params_host(seed, cfg, device)
    return _state(params, lr, offload_opt, mu_dtype)


def _check_placement(params: dict, opt_state, offload_opt: bool) -> None:
    """Adam's moments in host memory with ``offload_opt``, else beside the
    parameters."""
    have = next(iter(opt_state[0].mu.values())).device
    want = (torch.device("cpu") if offload_opt
            else next(iter(params.values())).device)
    if have != want:
        raise ValueError(f"offload_opt={offload_opt}: Adam's moments are on "
                         f"{have}, expected on {want}")


def make_train_step(cfg: LlamaConfig, tx, remat=False,
                    offload_opt: bool = False, opt_state=None,
                    ce_block: int | None = None, fold_steps: int = 0):
    """``step(params, opt_state, tokens) -> (params, opt_state, loss)``,
    updating params and state in place. ``remat`` and ``ce_block`` as in
    :func:`~oncilla_tpu_torch.models.llama.loss_fn`; ``offload_opt`` needs
    the state of the matching ``make_train_state*(offload_opt=True)`` as
    ``opt_state``, and a state passed without it raises, as the JAX
    package's step factory does. ``fold_steps`` N > 0 runs N steps on the
    batch back to back with no host synchronisation (eager launches are
    asynchronous: the same math as the JAX package's one-dispatch fold)
    and returns the last loss."""
    if not offload_opt and opt_state is not None:
        raise ValueError(
            "an opt_state example was passed but offload_opt is False: the "
            "offloaded (pinned host) state needs offload_opt=True on the "
            "step too")
    if offload_opt and opt_state is None:
        raise ValueError(
            "offload_opt needs opt_state (the state built by the matching "
            "make_train_state*(offload_opt=True))")

    def one(params, opt_state, tokens):
        _check_placement(params, opt_state, offload_opt)
        # Detached aliases carry the graph, so the caller's tensors stay
        # plain (requires_grad False) and are updated in place below.
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, tokens, cfg, remat=remat,
                           ce_block=ce_block)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        tx.step(params, dict(zip(params, grads)), opt_state)
        return params, opt_state, loss.detach()

    def step(params, opt_state, tokens):
        for _ in range(max(fold_steps, 1)):
            params, opt_state, loss = one(params, opt_state, tokens)
        return params, opt_state, loss

    return step


def sample_batch(rng: np.random.Generator, cfg: LlamaConfig, batch: int,
                 seq: int, device=None) -> torch.Tensor:
    """Uniform token ids (batch, seq), int32: the JAX package's draws."""
    ids = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    return torch.from_numpy(ids).to(resolve_device(device))


def make_eval_step(cfg: LlamaConfig):
    """``step(params, tokens) -> loss``: mean next-token cross entropy, no
    gradients."""
    @torch.no_grad()
    def step(params, tokens):
        return loss_fn(params, tokens, cfg)

    return step


def evaluate(params, batches, eval_step) -> dict:
    """Token-weighted mean loss and perplexity over an iterable of token
    batches: each batch's loss weighs its B·(S-1) predicted tokens, so a
    short remainder batch does not bias the result. The losses stay on the
    device until the end (one synchronisation)."""
    losses, weights = [], []
    for tokens in batches:
        losses.append(eval_step(params, tokens))
        weights.append(tokens.shape[0] * (tokens.shape[1] - 1))
    if not losses:
        raise ValueError("evaluate() got an empty batch iterable")
    w = np.asarray(weights, np.float64)
    ls = torch.stack(losses).double().cpu().numpy()
    mean = float((ls * w).sum() / w.sum())
    return {"loss": mean, "perplexity": float(np.exp(mean)),
            "batches": len(losses)}
