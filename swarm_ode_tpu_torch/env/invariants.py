"""Debug-mode simulation invariant checks over a batch of B envs.

Counterpart of `swarm_ode_tpu/env/invariants.py`. The JAX package asserts
with checkify inside jit; here each invariant is a (B,) flag computed where
the state lies, all flags come back to the host in one copy, and the first
broken one raises `InvariantError` with the JAX package's message and the
envs that break it. The copy synchronises, so this stays off the hot path:
`checked_step` is the debug-mode env, analogous to a sanitizer build.
"""
from __future__ import annotations

from typing import Optional

import torch

from swarm_ode_tpu_torch.definitions import AgentType
from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.queries import id_flags
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState


class InvariantError(RuntimeError):
    """An env state broke a simulation invariant."""


def _no_pair(same: torch.Tensor) -> torch.Tensor:
    """(B,) True where the (B, N, N) relation holds for no off-diagonal pair."""
    n = same.shape[-1]
    off = ~torch.eye(n, dtype=torch.bool, device=same.device)
    return ~(same & off).flatten(1).any(dim=1)


def state_flags(params: EnvParams, state: EnvState):
    """[(message, (B,) bool holds)] of every invariant, in the JAX
    package's order."""
    S = params.num_shelves
    x, y = state.agent_xy[..., 0], state.agent_xy[..., 1]
    checks = [
        ("agent x oob", ((x >= 0) & (x < params.grid_w)).all(dim=1)),
        ("agent y oob", ((y >= 0) & (y < params.grid_h)).all(dim=1)),
    ]
    # No two same-layer agents on one cell unless one is fixing a clash
    # (warehouse.py:474-478).
    is_picker = params.agent_type == AgentType.PICKER
    same_cell = (x[:, :, None] == x[:, None, :]) & (y[:, :, None] == y[:, None, :])
    same_layer = is_picker[:, None] == is_picker[None, :]
    fixing = state.agent_fixing_clash > 0
    fixing_pair = fixing[:, :, None] | fixing[:, None, :]
    checks.append(("same-layer agents overlap without fixing-clash",
                   _no_pair(same_cell & same_layer & ~fixing_pair)))
    # Every shelf is on the grid or carried by exactly one agent.
    # (An invalid id counts nowhere: it goes to a last, dropped slot.)
    carrying = state.agent_carrying
    valid_id = (carrying >= 0) & (carrying <= S)
    slot = torch.where(valid_id, carrying, S + 1).long()
    counts = torch.zeros(carrying.shape[0], S + 2, dtype=torch.int32, device=carrying.device)
    counts = counts.scatter_add(1, slot, torch.ones_like(carrying))
    checks.append(("shelf carried by multiple agents", (counts[:, 1:S + 1] <= 1).all(dim=1)))
    checks.append(("invalid carried shelf id", valid_id.all(dim=1)))
    rq = state.request_queue
    checks.append(("invalid request queue entry", ((rq >= 1) & (rq <= S)).all(dim=1)))
    checks.append(("duplicate request queue entries",
                   _no_pair(rq[:, :, None] == rq[:, None, :])))
    # Non-carried shelves occupy distinct cells.
    on_grid = ~id_flags(torch.where(valid_id, carrying, 0), S)
    sx, sy = state.shelf_xy[..., 0], state.shelf_xy[..., 1]
    s_same = (sx[:, :, None] == sx[:, None, :]) & (sy[:, :, None] == sy[:, None, :])
    checks.append(("two shelves on one cell",
                   _no_pair(s_same & on_grid[:, :, None] & on_grid[:, None, :])))
    return checks


def check_state(params: EnvParams, state: EnvState) -> None:
    """Raise InvariantError at the first broken invariant (one host copy)."""
    checks = state_flags(params, state)
    held = torch.stack([ok for _, ok in checks]).cpu()  # (n_checks, B)
    for (msg, _), ok in zip(checks, held):
        if not bool(ok.all()):
            envs = (~ok).nonzero().flatten().tolist()
            raise InvariantError(f"{msg} (envs {envs})")


def checked_step(params: EnvParams):
    """A step function that raises on invariant violations of the state it
    returns: wrapped(state, actions, generator=None, noise=None) ->
    step_mod.step's (new_state, rewards, done, info)."""

    def wrapped(state: EnvState, actions: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[step_mod.StepNoise] = None):
        out = step_mod.step(params, state, actions, generator=generator, noise=noise)
        check_state(params, out[0])
        return out

    return wrapped
