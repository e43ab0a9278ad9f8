"""The random draws of a policy rollout, from one torch.Generator.

The JAX package threads PRNG keys through its rollouts; the port's
rollouts take their draws from an object with these methods instead, so a
run can draw them from a generator (this class) or be given the JAX
package's own draws (the parity tests rebuild them from JAX's keys in its
split order). Every draw lands on the params' device.
"""
from __future__ import annotations

import torch

from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState


class RolloutDraws:
    """reset: B fresh episodes; step: one env step's draws; gumbel: (B, A,
    num_actions) standard Gumbels for sampling the agents' actions
    (jax.random.categorical and coordinated_sample are Gumbel-max);
    coin: (B,) uniforms; permutation: a random order of range(n); split:
    the draws of a side rollout such as an evaluation probe (JAX splits a
    key there; one generator serves both here)."""

    def __init__(self, params: EnvParams, generator: torch.Generator):
        self.params, self.generator = params, generator

    def reset(self, B: int) -> EnvState:
        return step_mod.reset(self.params, B, self.generator)

    def step(self, B: int) -> step_mod.StepNoise:
        return step_mod.draw_noise(self.params, B, self.generator)

    def gumbel(self, B: int) -> torch.Tensor:
        p = self.params
        return step_mod.draw_gumbel((B, p.num_agents, p.num_actions), self.generator, p.device)

    def coin(self, B: int) -> torch.Tensor:
        return torch.rand((B,), generator=self.generator, device=self.params.device)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.params.device)

    def split(self) -> "RolloutDraws":
        return self


def as_draws(params: EnvParams, draws) -> RolloutDraws:
    """`draws` as a draws object: a torch.Generator is wrapped, anything
    else is taken as one."""
    if isinstance(draws, torch.Generator):
        return RolloutDraws(params, draws)
    return draws
