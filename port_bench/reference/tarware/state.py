"""Environment state and device parameters as dataclasses of tensors.

Frozen copy, for the benchmark's reference, of the program's `env/state.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

Counterpart of `swarm_ode_tpu/env/state.py`. The JAX package keeps one env
per pytree and batches with `vmap`; here every `EnvState` and `HeuristicState`
tensor carries an explicit leading batch dimension B, while `EnvParams` holds
the per-layout constants once (no batch dimension). Integer state is int32 as
in the JAX package; indices are widened to int64 only where they index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import EnvConfig
from .definitions import AgentType
from .layout import Layout, build_layout
from .queries import cell_max, id_flags, occupant_grid
from .bfs import class_base_rows


BFS_BACKENDS = ("auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static per-layout data: Python scalars plus constant tensors that all
    live on `device`."""

    # --- static scalars ---
    num_agvs: int
    num_pickers: int
    num_agents: int
    num_goals: int
    num_racks: int
    num_shelves: int
    num_actions: int  # incl. noop
    grid_h: int
    grid_w: int
    request_queue_size: int
    max_steps: int  # 0 = unlimited
    max_inactivity_steps: int  # 0 = unlimited
    column_height: int
    reward_type: int
    normalised_coordinates: bool
    observation_type: str
    replan_mode: str
    bfs_backend: str  # 'xla' = full field (K3); 'auto' | 'pallas' = compacted query
    dynamic_bfs_iters: int
    bfs_kernel: str  # 'int32' | 'bitpack32'
    replan_row_frac: float
    replan_rejoin: bool
    deadlock_break: int
    device: torch.device
    # --- tensors ---
    agent_type: torch.Tensor  # (A,) int32 AgentType
    highway: torch.Tensor  # (H, W) bool
    is_goal: torch.Tensor  # (H, W) bool
    picker_passable: torch.Tensor  # (H, W) bool
    action_cells: torch.Tensor  # (T, 2) int32 (y, x); action id a -> row a-1
    goals_yx: torch.Tensor  # (G, 2) int32
    rack_cells: torch.Tensor  # (L, 2) int32 action order
    rack_group: torch.Tensor  # (L,) int32
    obs_rack_perm: torch.Tensor  # (L,) int32
    obs_rack_perm_inv: torch.Tensor  # (L,) int32
    rack_locations_xyg: torch.Tensor  # (L, 3) int32
    cell_to_rack: torch.Tensor  # (H, W) int32
    shelf_cells: torch.Tensor  # (S, 2) int32 spawn cell of shelf s+1
    highway_cells: torch.Tensor  # (Hw, 2) int32, y-major order
    field_dist_picker: torch.Tensor  # (T, H, W) int32
    field_next_dir_picker: torch.Tensor  # (T, H, W) int8
    # (2, H*(W+1)) bool, walled: the replan query's class base rows (free
    # grid, picker_passable), made from picker_passable with the params.
    replan_base: torch.Tensor = dataclasses.field(init=False, repr=False)
    # (B,) bool or None: envs whose every row the replan query answers, as
    # the program's compacted query does for an env inside the first K rows
    # while the batch's needed rows leave room (pathfinding.replan_query).
    every_row: Optional[torch.Tensor] = None

    def __post_init__(self):
        object.__setattr__(self, "replan_base", class_base_rows(self.picker_passable))


@dataclasses.dataclass
class EnvState:
    """Full dynamic state of B envs. The JAX state's PRNG `key` has no
    counterpart: random draws come from a `torch.Generator` or are passed in
    (see env/step.py)."""

    agent_xy: torch.Tensor  # (B, A, 2) int32 (x, y)
    agent_dir: torch.Tensor  # (B, A) int32 Direction
    agent_busy: torch.Tensor  # (B, A) bool
    agent_target: torch.Tensor  # (B, A) int32 action id, 0 = none
    agent_carrying: torch.Tensor  # (B, A) int32 shelf id, 0 = none
    agent_fixing_clash: torch.Tensor  # (B, A) int32
    agent_replan: torch.Tensor  # (B, A) bool
    agent_has_delivered: torch.Tensor  # (B, A) bool
    agent_req_action: torch.Tensor  # (B, A) int32
    stuck_count: torch.Tensor  # (B, A) int32
    stuck_xy: torch.Tensor  # (B, A, 2) int32
    agent_break: torch.Tensor  # (B, A) int32
    shelf_xy: torch.Tensor  # (B, S, 2) int32
    request_queue: torch.Tensor  # (B, R) int32 shelf ids (1-based)
    cur_steps: torch.Tensor  # (B,) int32
    cur_inactive: torch.Tensor  # (B,) int32

    @property
    def batch(self) -> int:
        return self.agent_dir.shape[0]

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def make_params(
    config: EnvConfig,
    layout: Optional[Layout] = None,
    device: torch.device | str = "cuda",
) -> EnvParams:
    """Build the per-layout constants on `device` (the card unless the
    caller asks for the CPU) from a host layout."""
    if config.bfs_backend not in BFS_BACKENDS:
        raise ValueError(f"bfs_backend must be one of {BFS_BACKENDS}, got {config.bfs_backend!r}")
    lay = layout or build_layout(config)
    dev = torch.device(device)
    H, W = lay.grid_size
    if config.num_pickers > 0:
        agent_type = np.array(
            [AgentType.AGV] * config.num_agvs
            + [AgentType.PICKER] * config.num_pickers,
            dtype=np.int32,
        )
    else:
        # No pickers: AGVs act as self-loading AGENTs (warehouse.py:171-175).
        agent_type = np.full(config.num_agvs, AgentType.AGENT, dtype=np.int32)

    highway_cells = np.argwhere(lay.highway).astype(np.int32)  # (Hw, 2) (y, x)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return EnvParams(
        num_agvs=config.num_agvs,
        num_pickers=config.num_pickers,
        num_agents=config.num_agents,
        num_goals=lay.num_goals,
        num_racks=lay.num_racks,
        num_shelves=lay.num_shelves,
        num_actions=lay.num_actions,
        grid_h=H,
        grid_w=W,
        request_queue_size=config.request_queue_size,
        max_steps=config.max_steps or 0,
        max_inactivity_steps=config.max_inactivity_steps or 0,
        column_height=config.column_height,
        reward_type=config.reward_type,
        normalised_coordinates=config.normalised_coordinates,
        observation_type=config.observation_type,
        replan_mode=config.replan_mode,
        bfs_backend=config.bfs_backend,
        # Replan-BFS sweep count: 32 on medium, scaled with the H+W diameter
        # on larger maps (same rule as the JAX package).
        dynamic_bfs_iters=(
            config.dynamic_bfs_iters
            if config.dynamic_bfs_iters
            else max(32, (2 * (H + W)) // 3)
        ),
        # 'auto': the bit-packed kernel needs the walled row to fit one
        # 32-bit word (ops/bfs_bitpack._plan); every predefined size fits.
        bfs_kernel=(
            ("bitpack32" if W + 1 < 32 else "int32")
            if config.bfs_kernel == "auto"
            else config.bfs_kernel
        ),
        replan_row_frac=config.replan_row_frac,
        replan_rejoin=config.replan_rejoin,
        deadlock_break=config.deadlock_break,
        device=dev,
        agent_type=t(agent_type),
        highway=t(lay.highway),
        is_goal=t(lay.is_goal_grid),
        picker_passable=t(lay.picker_passable),
        action_cells=t(lay.action_cells_yx),
        goals_yx=t(lay.goals_yx),
        rack_cells=t(lay.rack_cells_yx),
        rack_group=t(lay.rack_group_action_order),
        obs_rack_perm=t(lay.obs_rack_perm),
        obs_rack_perm_inv=t(np.argsort(lay.obs_rack_perm).astype(np.int32)),
        rack_locations_xyg=t(lay.rack_locations_xyg),
        cell_to_rack=t(lay.cell_to_rack),
        shelf_cells=t(lay.shelf_cells_yx),
        highway_cells=t(highway_cells),
        field_dist_picker=t(lay.field_dist[1]),
        field_next_dir_picker=t(lay.field_next_dir[1]),
    )


def agent_class(params: EnvParams) -> torch.Tensor:
    """(A,) int32 path-planning class: 0 = free grid (AGV/AGENT), 1 = picker."""
    return (params.agent_type == AgentType.PICKER).to(torch.int32)


def occupancy_grids(params: EnvParams, state: EnvState):
    """The four (B, H, W) int32 collision layers, recomputed from state.

    Mirrors `_recalc_grid` (reference warehouse.py:319-330): agent ids per
    layer, non-carried shelf ids, and carried shelf ids at the carriers'
    cells. Same-cell occupants resolve to the highest id, like the JAX
    package's scatter-max.
    """
    H, W = params.grid_h, params.grid_w
    B = state.batch
    is_picker = params.agent_type == AgentType.PICKER
    carried = id_flags(state.agent_carrying, params.num_shelves)
    grids = (
        occupant_grid(state.agent_xy, ~is_picker, H, W),
        occupant_grid(state.agent_xy, is_picker, H, W),
        occupant_grid(state.shelf_xy, ~carried, H, W),
        cell_max(state.agent_xy, state.agent_carrying, H, W),
    )
    return tuple(g.view(B, H, W) for g in grids)
