"""Faults planted in the program's timed path, to show that the judge fails
them: the tests plant them on the CPU, `calibrate --fault` on the card.

Each function returns (object, attribute, replacement) for a monkeypatch:
  unchanged  the step returns its state unchanged;
  half       half of the batch left out (the training loss the mean over
             the rest; served windows zeroed; half of the envs not stepped);
  altered    an answer altered where it is produced.
"""
from __future__ import annotations

import dataclasses

import torch


def step_fault(kind: str):
    from swarm_ode_tpu_torch.env import step as step_mod

    orig = step_mod.step

    def step(params, state, actions, generator=None, noise=None):
        new, rewards, done, info = orig(params, state, actions, generator=generator, noise=noise)
        if kind == "unchanged":
            return state, rewards, done, info
        if kind == "half":
            B = state.agent_dir.shape[0]
            keep = torch.arange(B, device=state.agent_dir.device) < B // 2

            def pick(a, b):
                return torch.where(keep.view(-1, *[1] * (a.dim() - 1)), a, b)

            new = dataclasses.replace(new, **{f.name: pick(getattr(new, f.name),
                                                           getattr(state, f.name))
                                              for f in dataclasses.fields(new)})
            return new, rewards, done, info
        return new, rewards, done, dict(info, shelf_deliveries=info["shelf_deliveries"] + 1)

    return step_mod, "step", step


def train_fault(kind: str):
    from swarm_ode_tpu_torch.train import train_gde

    if kind == "unchanged":
        return train_gde, "adamw_update", lambda params, grads, state, *a, **k: state
    if kind == "half":
        def weighted_mean(losses, batch):
            n = losses.shape[0] // 2
            return (losses[:n] * batch["weight"][:n]).sum() / batch["weight"][:n].sum()

        return train_gde, "weighted_mean", weighted_mean
    orig = train_gde.train_step

    def train_step(*a, **k):
        opt, loss = orig(*a, **k)
        return opt, loss * 1.001

    return train_gde, "train_step", train_step


def serve_fault(kind: str):
    from swarm_ode_tpu_torch import serving

    orig = serving.GDEPredictor.forward

    def forward(self, obs, count):
        out = orig(self, obs, count).clone()
        if kind == "half":
            out[out.shape[0] // 2:] = 0.0
        else:
            out[0, 1, 0, 0] += 0.05
        return out

    return serving.GDEPredictor, "forward", forward


BY_RUNNER = {"rollout": step_fault, "gde_train": train_fault, "gde_serve": serve_fault}
