"""Gym wrappers (reference tarware/utils/wrappers.py:10-96).

Working equivalents of the reference set — `FlattenAgents` there references
a nonexistent `env.msg_bits` (stale upstream code, SURVEY.md §2.6); here it
flattens the actual joint action/observation spaces.

A copy of `swarm_ode_tpu/env/wrappers.py` (gymnasium and numpy) for the
port's gym adapter. It needs gymnasium, which the port's other modules do
not.
"""
from __future__ import annotations

import math

import gymnasium as gym
import numpy as np
from gymnasium import ObservationWrapper, spaces


class FlattenAgents(gym.Wrapper):
    """Joint MultiDiscrete action space + concatenated observations
    (reference wrappers.py:10-43, sans the msg_bits bug)."""

    def __init__(self, env):
        super().__init__(env)
        n = env.unwrapped.num_agents
        size = env.unwrapped.action_size
        self.n_agents = n
        self.action_space = spaces.MultiDiscrete(n * [size])
        total = sum(
            int(np.prod(s.shape)) for s in env.observation_space
        )
        self.observation_space = spaces.Box(
            -np.inf, np.inf, shape=(total,), dtype=np.float32
        )

    def reset(self, **kwargs):
        obs = self.env.reset(**kwargs)
        if isinstance(obs, tuple) and len(obs) == 2 and isinstance(obs[1], dict):
            obs = obs[0]
        return np.concatenate([np.asarray(o).ravel() for o in obs])

    def step(self, action):
        action = np.asarray(action).reshape(self.n_agents)
        obs, reward, terminated, truncated, info = self.env.step(list(action))
        obs = np.concatenate([np.asarray(o).ravel() for o in obs])
        return (
            obs,
            float(np.sum(reward)),
            all(terminated),
            all(truncated),
            info,
        )


class DictAgents(gym.Wrapper):
    """RLLib-style dict obs/actions keyed `agent_{i}` (reference
    wrappers.py:46-73)."""

    def _keys(self):
        n = self.env.unwrapped.num_agents
        digits = int(math.log10(n)) + 1
        return [f"agent_{i:{digits}}" for i in range(n)]

    def reset(self, **kwargs):
        obs = self.env.reset(**kwargs)
        if isinstance(obs, tuple) and len(obs) == 2 and isinstance(obs[1], dict):
            obs = obs[0]
        return dict(zip(self._keys(), obs))

    def step(self, action):
        keys = self._keys()
        assert keys == sorted(action.keys())
        acts = [action[k] for k in keys]
        obs, reward, terminated, truncated, info = self.env.step(acts)
        out_t = dict(zip(keys, terminated))
        out_tr = dict(zip(keys, truncated))
        out_tr["__all__"] = all(truncated)
        return (
            dict(zip(keys, obs)),
            dict(zip(keys, reward)),
            out_t,
            out_tr,
            info,
        )


class FlattenSAObservation(ObservationWrapper):
    """Flatten each agent's observation (reference wrappers.py:76-90)."""

    def __init__(self, env):
        super().__init__(env)
        ma_spaces = []
        for sa_obs in env.observation_space:
            flatdim = spaces.flatdim(sa_obs)
            ma_spaces.append(
                spaces.Box(-np.inf, np.inf, shape=(flatdim,), dtype=np.float32)
            )
        self.observation_space = spaces.Tuple(tuple(ma_spaces))

    def observation(self, observation):
        return [
            spaces.flatten(s, o)
            for s, o in zip(self.env.observation_space, observation)
        ]


class SquashDones(gym.Wrapper):
    """Collapse per-agent done lists to one bool (reference wrappers.py:92-96,
    updated to the 5-tuple API)."""

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return obs, reward, all(terminated), all(truncated), info
