"""AdamW in place: the counterpart of ``optax.adamw`` as the JAX package's
``models/train.py`` builds it (``optax.adamw(lr, weight_decay=0.01,
mu_dtype=...)``).

The arithmetic is optax 0.2.6's ``scale_by_adam`` ->
``add_decayed_weights`` -> ``scale_by_learning_rate`` -> ``apply_updates``
as the JAX package's jitted step computes it, leaf by leaf:

- µ' = (1-b1)·g + b1·µ, ν' = (1-b2)·g² + b2·ν,
  u = µ'/(1-b1^t) / (sqrt(ν'/(1-b2^t)) + eps): ε is added after the
  square root, the count t is an int32 incremented without overflow
  and the bias corrections are float32;
- u += weight_decay · p on every leaf, norms included (optax's ``mask`` is
  None in the JAX package), then p = p + (-lr) · u;
- every Python scalar is rounded to the dtype JAX's weak typing gives it
  (the dtype of the tensor it meets: b1 is 0.8984375 against a bf16 µ);
- the arithmetic runs in float32 and each result is rounded once, to its
  storage dtype: µ to ``mu_dtype`` (after the update used it unrounded), ν
  and p to the parameter's dtype. XLA keeps the intermediates of a fused
  elementwise program at float32 the same way (its excess precision).

The state has optax's structure, ``(ScaleByAdamState(count, mu, nu),
EmptyState(), EmptyState())``, so a checkpoint of it carries the JAX
package's key paths (``[0]/.mu/['embed']``). The step writes parameters and
moments in place under ``torch.no_grad``, the counterpart of the JAX step's
donation. Moments may live off the parameters' device (pinned host memory,
``offload_opt``): each leaf's moments are brought to the parameter's
device, updated there and written back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oncilla_tpu_torch.models.llama import params_from_jax, tensor_from_numpy
from oncilla_tpu_torch.utils.platform import resolve_device


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    pass


def _scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a JAX weak-typed scalar is before
    it meets a tensor of that dtype (rounded on the host: no device copy,
    so the step never synchronises)."""
    return torch.tensor(value, dtype=dtype).item()


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    top = torch.iinfo(count.dtype).max
    return torch.where(count < top, count + 1, count)


# optax.adamw's defaults, which the JAX package keeps: b1, b2, eps (its
# eps_root is 0.0, and adding it changes no value).
B1, B2, EPS = 0.9, 0.999, 1e-8
# Elements a leaf updates at a time (256 MB of each float32 temporary).
CHUNK = 1 << 26


class AdamW:
    """``optax.adamw(lr, weight_decay=weight_decay, mu_dtype=mu_dtype)``
    with an in-place step (:meth:`step`); built by :func:`adamw`."""

    def __init__(self, lr: float, weight_decay: float,
                 mu_dtype: torch.dtype | None):
        self.lr = lr
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params: dict, host: bool = False) -> tuple:
        """Zero moments shaped like ``params``: µ in ``mu_dtype`` (else the
        parameter's dtype), ν in the parameter's dtype. ``host`` keeps them
        in host memory, pinned when the parameters are on a card."""
        def zeros(p, dtype):
            if not host:
                return torch.zeros_like(p, dtype=dtype)
            return torch.zeros(p.shape, dtype=dtype,
                               pin_memory=p.device.type == "cuda")

        dev = next(iter(params.values())).device
        mu = {k: zeros(p, self.mu_dtype or p.dtype) for k, p in params.items()}
        nu = {k: zeros(p, p.dtype) for k, p in params.items()}
        count = torch.zeros((), dtype=torch.int32, device=dev)
        return (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: tuple) -> tuple:
        """One update of ``params`` and ``state`` in place; returns
        ``state``. Moments in pinned host memory are written back
        asynchronously, in stream order: synchronise before reading them
        on the host."""
        adam = state[0]
        count = _safe_increment(adam.count)
        adam.count.copy_(count)
        bc1 = 1 - B1 ** count.float()
        bc2 = 1 - B2 ** count.float()
        for k, p in params.items():
            g, mu, nu = grads[k], adam.mu[k], adam.nu[k]
            # optax's dtypes, which pick each scalar's rounding.
            m_dt = torch.promote_types(g.dtype, mu.dtype)
            v_dt = torch.promote_types(g.dtype, nu.dtype)
            u_dt = torch.promote_types(torch.promote_types(m_dt, v_dt), p.dtype)
            c = (_scalar(1 - B1, g.dtype), _scalar(B1, mu.dtype),
                 _scalar(1 - B2, g.dtype), _scalar(B2, nu.dtype),
                 _scalar(EPS, v_dt), _scalar(self.weight_decay, p.dtype),
                 _scalar(-self.lr, u_dt))
            # Elementwise, so a leaf updates in chunks: the float32
            # temporaries stay at a few chunks, not a few leaves (a Mixtral
            # expert leaf is 3.8 GB in float32), and every element's
            # arithmetic is the same.
            pf, gf, muf, nuf = (p.view(-1), g.reshape(-1), mu.view(-1),
                                nu.view(-1))
            for lo in range(0, pf.numel(), CHUNK):
                sl = slice(lo, lo + CHUNK)
                self._update(pf[sl], gf[sl], muf[sl], nuf[sl], bc1, bc2, c)
        return state

    @staticmethod
    def _update(p, g, mu, nu, bc1, bc2, c) -> None:
        b1c, b1, b2c, b2, eps, wd, neg_lr = c
        crossing = mu.device != p.device
        mu_in = mu.to(p.device, non_blocking=True).float()
        nu_in = nu.to(p.device, non_blocking=True).float()
        gf = g.float()
        m = gf * b1c + mu_in * b1
        v = (gf * gf) * b2c + nu_in * b2
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        u = u + p.float() * wd
        p.copy_(p.float() + u * neg_lr)
        mu.copy_(m.to(mu.dtype), non_blocking=crossing)
        nu.copy_(v.to(nu.dtype), non_blocking=crossing)


def adamw(lr: float, weight_decay: float = 0.01,
          mu_dtype: torch.dtype | None = None) -> AdamW:
    """The optimizer of the JAX package's train state
    (``optax.adamw(lr, weight_decay=0.01, mu_dtype=mu_dtype)``)."""
    return AdamW(lr, weight_decay, mu_dtype)


def opt_state_from_jax(optax_state, device=None) -> tuple:
    """The Adam state of the JAX package's ``make_train_state_host``
    (``optax.adamw``'s state, or its ``ScaleByAdamState`` alone), its
    leaves handed over as numpy arrays, as the port's state on
    ``device``: a JAX-trained state steps on in the port."""
    dev = resolve_device(device)
    adam = optax_state if hasattr(optax_state, "mu") else next(
        s for s in optax_state if hasattr(s, "mu"))
    return (ScaleByAdamState(
        count=tensor_from_numpy(adam.count, dev).to(torch.int32).reshape(()),
        mu=params_from_jax(adam.mu, dev),
        nu=params_from_jax(adam.nu, dev),
    ), EmptyState(), EmptyState())
