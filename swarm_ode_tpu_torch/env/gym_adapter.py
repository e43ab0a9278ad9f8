"""Gymnasium-compatible adapter over the port's batched env, one env at a time.

Counterpart of `swarm_ode_tpu/env/gym_adapter.py`, with the reference
`Warehouse(gym.Env)`'s API (warehouse.py:91-766): the same constructor
kwargs (plus `device`), the same action and observation spaces, `reset(seed)`
returning the bare observation tuple (reference quirk, warehouse.py:666),
and `step` returning `terminateds` twice (warehouse.py:704).

A thin host-side shell around `env/step.py` and `env/observations.py` at
B = 1, not a second implementation. Every `step` reads its results back to
the host: the gym contract is one synchronous step at a time. gymnasium is
optional, as in the JAX package: without it the class is a plain object
with no spaces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:  # pragma: no cover
    gym = None

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.definitions import RewardType
from swarm_ode_tpu_torch.env import observations, step as step_mod
from swarm_ode_tpu_torch.env.layout import build_layout
from swarm_ode_tpu_torch.env.state import make_params


@dataclasses.dataclass
class ShelfView:
    """Lightweight stand-in for the reference Shelf entity
    (warehouse.py:67-71): id + current coordinates."""

    id: int
    x: int
    y: int


class Warehouse(gym.Env if gym else object):
    """The reference's Warehouse over one env of the port (B = 1) on
    `device`, the card unless the caller asks for the CPU.

    Random draws come from the adapter's own `torch.Generator`. A seeded
    `reset(seed)` reseeds it; an unseeded reset continues its stream (the
    first one, before any seed, starts from seed 0). So unseeded episodes
    differ from one another, as the reference's do (it continues the global
    numpy RNG, warehouse.py:764-766); the JAX adapter gets the same property
    by folding the previous episode's key."""

    metadata = {"render_modes": ["human", "rgb_array"]}

    def __init__(
        self,
        shelf_columns: int,
        column_height: int,
        shelf_rows: int,
        num_agvs: int,
        num_pickers: int,
        request_queue_size: int,
        max_inactivity_steps: Optional[int],
        max_steps: Optional[int],
        reward_type=RewardType.INDIVIDUAL,
        normalised_coordinates: bool = False,
        observation_type: str = "global",
        replan_mode: str = "bfs",
        device: torch.device | str = "cuda",
    ):
        self.config = EnvConfig(
            shelf_rows=shelf_rows,
            shelf_columns=shelf_columns,
            column_height=column_height,
            num_agvs=num_agvs,
            num_pickers=num_pickers,
            request_queue_size=request_queue_size,
            max_inactivity_steps=max_inactivity_steps,
            max_steps=max_steps,
            reward_type=int(reward_type),
            normalised_coordinates=normalised_coordinates,
            observation_type=observation_type,
            replan_mode=replan_mode,
        )
        self.layout = build_layout(self.config)
        self.params = make_params(self.config, self.layout, device)
        self._generator = torch.Generator(device=self.params.device).manual_seed(0)
        self._state = None
        self.renderer = None

        self.num_agvs = num_agvs
        self.num_pickers = num_pickers
        self.num_agents = num_agvs + num_pickers
        self.grid_size = self.layout.grid_size
        self.action_size = self.layout.num_actions
        # goals as (x, y) tuples; action map as {id: (y, x)} (reference
        # warehouse.py:242-249).
        self.goals: List[Tuple[int, int]] = [
            (int(x), int(y)) for (y, x) in self.layout.goals_yx
        ]
        self.action_id_to_coords_map: Dict[int, Tuple[int, int]] = {
            i + 1: (int(y), int(x))
            for i, (y, x) in enumerate(self.layout.action_cells_yx)
        }
        self.rack_groups = [
            [tuple(map(int, yx)) for yx in grp]
            for grp in _groups_from_layout(self.layout)
        ]

        if gym:
            self.action_space = spaces.Tuple(
                tuple(self.num_agents * [spaces.Discrete(self.action_size)])
            )
            agv_len, picker_len = observations.obs_lengths(self.params)
            lens = [agv_len] * num_agvs + [picker_len] * num_pickers
            if num_pickers == 0:
                lens = [agv_len] * num_agvs
            self.observation_space = spaces.Tuple(
                tuple(
                    spaces.Box(-np.inf, np.inf, shape=(n,), dtype=np.float32)
                    for n in lens
                )
            )

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The port's EnvState of this one env (B = 1)."""
        return self._state

    @property
    def request_queue(self) -> List[ShelfView]:
        sxy = self._state.shelf_xy[0].cpu().numpy()
        return [
            ShelfView(int(s), int(sxy[s - 1, 0]), int(sxy[s - 1, 1]))
            for s in self._state.request_queue[0].cpu().numpy()
        ]

    def _split_obs(self, obs_padded: np.ndarray) -> Tuple[np.ndarray, ...]:
        agv_len, picker_len = observations.obs_lengths(self.params)
        out = []
        for i in range(self.num_agents):
            n = agv_len if (i < self.num_agvs and self.num_pickers > 0) else (
                picker_len if self.num_pickers > 0 else agv_len
            )
            out.append(np.asarray(obs_padded[i, :n], dtype=np.float32))
        return tuple(out)

    def _obs(self):
        return self._split_obs(observations.observe(self.params, self._state)[0].cpu().numpy())

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(int(seed))
        self._state = step_mod.reset(self.params, 1, self._generator)
        return self._obs()

    def step(self, macro_actions):
        actions = torch.from_numpy(np.asarray(macro_actions, dtype=np.int32).reshape(1, -1))
        self._state, rewards, done, info = step_mod.step(
            self.params, self._state, actions.to(self.params.device), generator=self._generator
        )
        terminateds = self.num_agents * [bool(done[0])]
        info = {k: _item(v[0]) for k, v in info.items()}
        # Reference quirk: terminateds returned for both slots
        # (warehouse.py:704).
        return (
            self._obs(),
            list(rewards[0].cpu().numpy().astype(np.float64)),
            terminateds,
            terminateds,
            info,
        )

    def compute_valid_action_masks(self, pickers_to_agvs=True,
                                   block_conflicting_actions=True):
        return observations.compute_valid_action_masks(
            self.params, self._state, pickers_to_agvs, block_conflicting_actions,
        )[0].cpu().numpy()

    def get_shelf_request_information(self):
        return observations.shelf_request_info(self.params, self._state)[0].cpu().numpy()

    def get_empty_shelf_information(self):
        return observations.empty_shelf_info(self.params, self._state)[0].cpu().numpy()

    def get_carrying_shelf_information(self):
        return observations.carrying_shelf_info(self.params, self._state)[0].tolist()

    def render(self, mode: str = "human"):
        from swarm_ode_tpu_torch.env.rendering import render_state

        return render_state(self.params, self.layout, self._state, mode)

    def close(self):
        pass

    @property
    def unwrapped(self):
        return self


def _groups_from_layout(layout):
    groups: Dict[int, list] = {}
    for ridx, g in enumerate(layout.rack_group_action_order):
        groups.setdefault(int(g), [])
    for k, ridx in enumerate(layout.obs_rack_perm):
        x, y, g = layout.rack_locations_xyg[k]
        groups[int(g)].append((int(y), int(x)))
    return [groups[g] for g in sorted(groups)]


def _item(v: torch.Tensor):
    a = v.cpu().numpy()
    return a.item() if a.ndim == 0 else a.tolist()
