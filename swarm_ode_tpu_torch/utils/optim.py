"""optax's chain(clip_by_global_norm(max_norm), adamw(lr, weight_decay=wd))
written out over lists of tensors with explicit state, as the GDE trainer
(`train/train_gde.py`) uses it and `convert.adamw_state_*` carries it to and
from optax's layout.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class AdamWState(NamedTuple):
    """optax.adamw's ScaleByAdamState: steps taken, first and second moments
    of each parameter (in the model's parameter order)."""

    count: torch.Tensor  # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    return AdamWState(torch.zeros((), dtype=torch.int32, device=params[0].device),
                      [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: each g as it is when the global norm is
    below max_norm, else g / norm * max_norm (not clip_grad_norm_'s
    max_norm / (norm + 1e-6) factor). norm: the global norm where the
    caller computed it (over leaves stored in shards on several ranks)."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scaled = torch._foreach_mul(torch._foreach_div(grads, norm), max_norm)
    keep = norm < max_norm
    return [torch.where(keep, g, s) for g, s in zip(grads, scaled)]


def adamw_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: AdamWState,
                 lr: float, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> AdamWState:
    """optax.adamw(lr, b1, b2, eps, weight_decay=...) applied to `params`
    in place (decoupled decay of every parameter):
    p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p).
    Returns the new state."""
    count = state.count + 1
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(state.mu, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                            torch._foreach_mul(state.nu, b2))
    mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, count))
    nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, count))
    upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
    upd = torch._foreach_add(upd, torch._foreach_mul(params, weight_decay))
    torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
    return AdamWState(count, mu, nu)
