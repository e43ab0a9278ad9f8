"""Functional environment API over a batch of B envs.

Counterpart of `swarm_ode_tpu/env/env.py`: `WarehouseEnv` binds a config to
the pure reset/step functions, and `rollout` / `auto_reset_rollout` run a
policy through the env for a number of steps. The JAX package writes one env
and vmaps it; here every state carries its batch dimension B, so the
single-env methods are the batched ones at B = 1 (their outputs keep the
batch dimension). Random draws come from a `torch.Generator`, or are passed
in per step (`noise`, and `fresh` for the auto-reset's states) so that a
test can replay the JAX package's draws. Nothing here reads a tensor back
to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env import observations, step as step_mod
from swarm_ode_tpu_torch.env.layout import build_layout
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState, make_params


class WarehouseEnv:
    """Thin wrapper binding an EnvConfig to the pure functions, on `device`
    (the card unless the caller asks for the CPU)."""

    def __init__(self, config: EnvConfig, device: torch.device | str = "cuda"):
        self.config = config
        self.layout = build_layout(config)
        self.params: EnvParams = make_params(config, self.layout, device)

    # ---- single env (B = 1) ----
    def reset(self, generator: torch.Generator):
        """(obs (1, A, D), state of one env)."""
        return self.reset_batch(1, generator)

    def step(self, state: EnvState, actions: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             noise: Optional[step_mod.StepNoise] = None):
        """(obs, new_state, rewards, done, info) of `state`'s envs;
        `actions` (B, A). Draws from `generator` unless `noise` is given."""
        new_state, rewards, done, info = step_mod.step(
            self.params, state, actions, generator=generator, noise=noise
        )
        obs = observations.observe(self.params, new_state)
        return obs, new_state, rewards, done, info

    def action_masks(self, state: EnvState) -> torch.Tensor:
        """(B, A, action_size) float32 valid-action masks."""
        return observations.compute_valid_action_masks(self.params, state)

    # ---- batched ----
    def reset_batch(self, B: int, generator: torch.Generator):
        """(obs (B, A, D), state) of B fresh episodes."""
        state = step_mod.reset(self.params, B, generator)
        return observations.observe(self.params, state), state

    step_batch = step


def _stack(steps):
    """Per-step (rewards, done, info) tuples -> the same stacked on a time
    axis after the batch one: (B, T, ...)."""
    rewards = torch.stack([r for r, _, _ in steps], dim=1)
    done = torch.stack([d for _, d, _ in steps], dim=1)
    info = {k: torch.stack([i[k] for _, _, i in steps], dim=1) for k in steps[0][2]}
    return rewards, done, info


def rollout(
    params: EnvParams,
    policy_step,
    policy_state,
    env_state: EnvState,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[step_mod.StepNoise]] = None,
):
    """Run a policy through B envs for `num_steps`, collecting per-step info.

    `policy_step(params, env_state, policy_state) -> (actions, policy_state)`.
    Returns (env_state, policy_state, (rewards, done, info)), each stacked
    (B, T, ...). Episodes do NOT auto-reset; see `auto_reset_rollout`. The
    step's draws come from `generator`, or from `noise[t]` at step t."""
    steps = []
    for t in range(num_steps):
        actions, policy_state = policy_step(params, env_state, policy_state)
        env_state, rewards, done, info = step_mod.step(
            params, env_state, actions, generator=generator,
            noise=None if noise is None else noise[t],
        )
        steps.append((rewards, done, info))
    return env_state, policy_state, _stack(steps)


def _where(done: torch.Tensor, new, cur):
    """Field by field: `new` in the envs where `done`, else `cur`."""
    out = {}
    for f in dataclasses.fields(cur):
        n, c = getattr(new, f.name), getattr(cur, f.name)
        out[f.name] = torch.where(done.view(-1, *([1] * (c.dim() - 1))), n, c)
    return type(cur)(**out)


def auto_reset_rollout(
    params: EnvParams,
    policy_step,
    policy_init,
    env_state: EnvState,
    policy_state,
    num_steps: int,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[step_mod.StepNoise]] = None,
    fresh: Optional[Sequence[EnvState]] = None,
):
    """Like `rollout`, but an env whose episode is done restarts in place.

    As in the JAX package, every step draws a fresh reset of all B envs and
    keeps it where `done`, so that no step reads `done` on the host.
    `policy_init(B)` returns a fresh policy state of B envs, kept the same
    way. The fresh states come from `generator` (after the step's draws), or
    are `fresh[t]` at step t. Returns (env_state, policy_state, (rewards,
    done, info)), done marking the episode boundaries."""
    B = env_state.batch
    fresh_pol = policy_init(B)
    steps = []
    for t in range(num_steps):
        actions, policy_state = policy_step(params, env_state, policy_state)
        env_state, rewards, done, info = step_mod.step(
            params, env_state, actions, generator=generator,
            noise=None if noise is None else noise[t],
        )
        new_env = step_mod.reset(params, B, generator) if fresh is None else fresh[t]
        env_state = _where(done, new_env, env_state)
        policy_state = _where(done, fresh_pol, policy_state)
        steps.append((rewards, done, info))
    return env_state, policy_state, _stack(steps)
