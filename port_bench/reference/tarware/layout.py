"""Warehouse layout generation and static shortest-path field precompute.

Frozen copy, for the benchmark's reference, of the program's `env/layout.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

Geometry parity: reference tarware/warehouse.py:215-259 (`_make_layout_from_params`)
and tarware/utils/utils.py:66-87 (`find_sections`).

A copy of `swarm_ode_tpu/env/layout.py` (pure numpy). Design note: the
reference calls a native C++ A* (pyastar2d,
warehouse.py:308) per agent per step. On unit-cost grids A* == BFS, and for
`care_for_agents=False` planning the obstacle grid is *static* per agent
class (AGVs: free grid; Pickers: highway-only plus the target cell,
warehouse.py:280-303). So we precompute, once per layout on the host, a
next-hop direction field and distance field from every possible target for
both agent classes. Path following on device is then a pure table gather —
no per-step graph search. Dynamic replanning around agents (the
`care_for_agents=True` case, warehouse.py:469,:502) is handled separately on
device (see swarm_ode_tpu_torch/env/pathfinding.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

from .config import EnvConfig
from .definitions import Direction

INF = np.int32(1 << 28)

# Fixed neighbor preference for next-hop tie-breaking: vertical moves first so
# followed paths are L-shaped (one turn per segment), like typical A* output.
# Order: UP, DOWN, LEFT, RIGHT as (dy, dx).
NEIGHBOR_DYDX = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)], dtype=np.int32)
NEIGHBOR_DIR = np.array(
    [Direction.UP, Direction.DOWN, Direction.LEFT, Direction.RIGHT], dtype=np.int8
)

_HIGHWAY_LANES = 2
_BOTTOM_ROWS = 2
_COLUMN_WIDTH = 2


def find_sections(pairs: List[Tuple[int, int]]) -> List[List[Tuple[int, int]]]:
    """Group rack cells into aisle sections by first-fit 4-adjacency.

    Faithful reimplementation of reference utils/utils.py:66-87 with
    aisle_per_sections=1 (the only value used, warehouse.py:202).
    """
    groups: List[List[Tuple[int, int]]] = []
    for pair in pairs:
        for group in groups:
            if any(abs(pair[0] - g[0]) + abs(pair[1] - g[1]) == 1 for g in group):
                group.append(pair)
                break
        else:
            groups.append([pair])
    return groups


def _bfs_fields(passable: np.ndarray, targets_yx: np.ndarray):
    """Multi-target BFS distance + next-hop fields over a static grid.

    Args:
      passable: (H, W) bool grid of traversable cells.
      targets_yx: (T, 2) int array of target coordinates (y, x). The target
        cell is always treated as passable (reference warehouse.py:285).

    Returns:
      dist: (T, H, W) int32 shortest path length to each target; INF if
        unreachable. Cells that are themselves impassable get
        1 + min(neighbor dist) ("step off" semantics — an agent standing on a
        blocked cell can still walk onto the best passable neighbor, which is
        how the reference unblocks the start cell, warehouse.py:303).
      next_dir: (T, H, W) int8 Direction to move along a shortest path;
        -1 where no move exists (at target or unreachable).
    """
    T = targets_yx.shape[0]
    H, W = passable.shape
    # Per-target passable grid: base grid plus own target cell.
    pas = np.broadcast_to(passable, (T, H, W)).copy()
    pas[np.arange(T), targets_yx[:, 0], targets_yx[:, 1]] = True

    dist = np.full((T, H, W), INF, dtype=np.int32)
    dist[np.arange(T), targets_yx[:, 0], targets_yx[:, 1]] = 0

    def shifted(d, dy, dx):
        """shifted(d, dy, dx)[t, y, x] == d[t, y+dy, x+dx] (INF out of bounds)."""
        out = np.full_like(d, INF)
        ys = slice(max(0, dy), H + min(0, dy))
        yd = slice(max(0, -dy), H - max(0, dy))
        xs = slice(max(0, dx), W + min(0, dx))
        xd = slice(max(0, -dx), W - max(0, dx))
        out[:, yd, xd] = d[:, ys, xs]
        return out

    # Min-plus relaxation to fixed point (vectorized over all targets).
    while True:
        best_nbr = np.full_like(dist, INF)
        for dy, dx in NEIGHBOR_DYDX:
            np.minimum(best_nbr, shifted(dist, dy, dx), out=best_nbr)
        new = np.where(pas, np.minimum(dist, best_nbr + 1), dist)
        if np.array_equal(new, dist):
            break
        dist = new

    # Next-hop over the pure passable-BFS distances: first direction (in
    # preference order) minimizing the *passable* neighbor's distance. This is
    # computed before the step-off augmentation so paths never route through
    # impassable cells.
    next_dir = np.full((T, H, W), -1, dtype=np.int8)
    best = np.full((T, H, W), INF, dtype=np.int64)
    for k in range(4):
        dy, dx = NEIGHBOR_DYDX[k]
        nbr = shifted(dist, dy, dx).astype(np.int64)
        nbr_pas = shifted(pas.astype(np.int32), dy, dx) > 0
        cand = np.where(nbr_pas, nbr, INF)
        take = cand < best
        next_dir = np.where(take, NEIGHBOR_DIR[k], next_dir)
        best = np.where(take, cand, best)

    # Step-off distances for impassable cells: 1 + best passable neighbor
    # (an agent standing on a blocked cell walks onto the best neighbor;
    # mirrors the reference unblocking the start cell, warehouse.py:303).
    step_off = np.where(best < INF, best + 1, INF).astype(np.int32)
    dist = np.where(pas, dist, step_off)
    # No move at the target itself or where nothing helps.
    at_target = dist == 0
    next_dir = np.where(at_target | (dist >= INF), -1, next_dir)
    return dist, next_dir


@dataclasses.dataclass(frozen=True)
class Layout:
    """All static, host-precomputed layout data (numpy). Immutable."""

    config: EnvConfig
    grid_size: Tuple[int, int]  # (H, W)
    highway: np.ndarray  # (H, W) bool
    goals_yx: np.ndarray  # (G, 2) int32, (y, x); reference stores (x, y)
    num_goals: int
    action_cells_yx: np.ndarray  # (T, 2) int32; action id a -> row a-1
    num_actions: int  # == action_size = T + 1 (incl. noop)
    rack_cells_yx: np.ndarray  # (L, 2) int32 in action-id order
    num_racks: int
    rack_group_action_order: np.ndarray  # (L,) int32 section id per rack cell
    num_groups: int
    obs_rack_perm: np.ndarray  # (L,) int32: obs slot k -> action-order rack idx
    rack_locations_xyg: np.ndarray  # (L, 3) int32 (x, y, group) in obs order
    shelf_cells_yx: np.ndarray  # (S, 2) int32 spawn cell of shelf id s+1
    num_shelves: int
    cell_to_rack: np.ndarray  # (H, W) int32 action-order rack idx, -1 elsewhere
    cell_to_shelfspawn: np.ndarray  # (H, W) int32 shelf spawn idx, -1 elsewhere
    is_goal_grid: np.ndarray  # (H, W) bool
    picker_passable: np.ndarray  # (H, W) bool: highway minus last row
    # Static shortest-path fields, indexed [agent_class, target, y, x] where
    # agent_class 0 = AGV/AGENT (free grid), 1 = PICKER (highway-restricted).
    field_dist: np.ndarray  # (2, T, H, W) int32
    field_next_dir: np.ndarray  # (2, T, H, W) int8


def _highway_lane_indices(axis_size: int, step: int) -> List[int]:
    # Reference warehouse.py:227-234.
    return [
        i + j
        for i in range(0, axis_size, step + _HIGHWAY_LANES)
        for j in range(_HIGHWAY_LANES)
    ]


@functools.lru_cache(maxsize=None)
def build_layout(config: EnvConfig) -> Layout:
    """Build the full static layout for a config. Cached per config."""
    if config.shelf_columns % 2 != 1:
        raise ValueError("Only odd number of shelf columns is supported")
    col_h = config.column_height
    H = (
        _HIGHWAY_LANES
        + (col_h + _HIGHWAY_LANES) * config.shelf_rows
        + _BOTTOM_ROWS
        + 1
    )
    W = _HIGHWAY_LANES + (_COLUMN_WIDTH + _HIGHWAY_LANES) * config.shelf_columns

    highway_ys = set(_highway_lane_indices(H, col_h))
    highway_xs = set(_highway_lane_indices(W, _COLUMN_WIDTH))

    def highway_func(x: int, y: int) -> bool:
        # Reference warehouse.py:239-240.
        return x in highway_xs or y in highway_ys or y >= H - 1 - _BOTTOM_ROWS

    highway = np.zeros((H, W), dtype=bool)
    for y in range(H):
        for x in range(W):
            highway[y, x] = highway_func(x, y)

    # Goals: last row, non-highway-column x positions (warehouse.py:242-245).
    goals_xy = [(x, H - 1) for x in range(W) if x not in highway_xs]
    goals_yx = np.array([(y, x) for (x, y) in goals_xy], dtype=np.int32)
    num_goals = len(goals_xy)

    # Action-id table: goals first, then rack cells scanned x-outer / y-inner
    # (warehouse.py:249-256).
    action_cells: List[Tuple[int, int]] = [(y, x) for (x, y) in goals_xy]
    rack_cells: List[Tuple[int, int]] = []
    for x in range(W):
        for y in range(H):
            if not highway_func(x, y) and (x, y) not in goals_xy:
                action_cells.append((y, x))
                rack_cells.append((y, x))
    action_cells_yx = np.array(action_cells, dtype=np.int32)
    rack_cells_yx = np.array(rack_cells, dtype=np.int32)
    L = len(rack_cells)

    # Rack sections (warehouse.py:202).
    groups = find_sections(rack_cells)
    num_groups = len(groups)
    rack_index = {tuple(c): i for i, c in enumerate(rack_cells)}
    rack_group_action_order = np.zeros(L, dtype=np.int32)
    obs_perm: List[int] = []
    rack_locations_xyg: List[Tuple[int, int, int]] = []
    for gi, group in enumerate(groups):
        for (y, x) in group:
            rack_group_action_order[rack_index[(y, x)]] = gi
            obs_perm.append(rack_index[(y, x)])
            rack_locations_xyg.append((x, y, gi))
    obs_rack_perm = np.array(obs_perm, dtype=np.int32)
    rack_locations_xyg = np.array(rack_locations_xyg, dtype=np.int32)

    # Shelf spawn cells: every non-highway cell, y-major order
    # (warehouse.py:632-639 — np.indices iteration is y-outer).
    shelf_cells: List[Tuple[int, int]] = []
    for y in range(H):
        for x in range(W):
            if not highway_func(x, y):
                shelf_cells.append((y, x))
    shelf_cells_yx = np.array(shelf_cells, dtype=np.int32)
    S = len(shelf_cells)

    cell_to_rack = np.full((H, W), -1, dtype=np.int32)
    for i, (y, x) in enumerate(rack_cells):
        cell_to_rack[y, x] = i
    cell_to_shelfspawn = np.full((H, W), -1, dtype=np.int32)
    for i, (y, x) in enumerate(shelf_cells):
        cell_to_shelfspawn[y, x] = i

    is_goal_grid = np.zeros((H, W), dtype=bool)
    for (y, x) in goals_yx:
        is_goal_grid[y, x] = True

    # Picker traversable grid: highway cells except the whole last row
    # (warehouse.py:287-292). Target cells are re-opened inside _bfs_fields.
    picker_passable = highway.copy()
    picker_passable[H - 1, :] = False

    agv_passable = np.ones((H, W), dtype=bool)

    dist_agv, nd_agv = _bfs_fields(agv_passable, action_cells_yx)
    dist_pick, nd_pick = _bfs_fields(picker_passable, action_cells_yx)

    # Bake in the reference's picker rack-crossing ban (warehouse.py:294-303):
    # a picker standing on a rack cell whose target is the horizontally
    # adjacent rack cell must take the long way around via its highway
    # neighbor (x+1 preferred, matching the override order at :297-300).
    for t, (ty, tx) in enumerate(action_cells_yx):
        if highway[ty, tx]:
            continue
        for sx in (tx - 1, tx + 1):
            if not (0 <= sx < W) or highway[ty, sx] or is_goal_grid[ty, sx]:
                continue
            # Start cell (ty, sx) is a rack cell horizontally adjacent to the
            # target rack cell.
            side = None
            if sx - 1 >= 0 and highway[ty, sx - 1]:
                side = sx - 1
            if sx + 1 < W and highway[ty, sx + 1]:
                side = sx + 1
            if side is None:
                continue
            nd_pick[t, ty, sx] = (
                Direction.RIGHT if side > sx else Direction.LEFT
            )
            d = dist_pick[t, ty, side]
            dist_pick[t, ty, sx] = d + 1 if d < INF else INF

    field_dist = np.stack([dist_agv, dist_pick]).astype(np.int32)
    field_next_dir = np.stack([nd_agv, nd_pick]).astype(np.int8)

    return Layout(
        config=config,
        grid_size=(H, W),
        highway=highway,
        goals_yx=goals_yx,
        num_goals=num_goals,
        action_cells_yx=action_cells_yx,
        num_actions=len(action_cells) + 1,
        rack_cells_yx=rack_cells_yx,
        num_racks=L,
        rack_group_action_order=rack_group_action_order,
        num_groups=num_groups,
        obs_rack_perm=obs_rack_perm,
        rack_locations_xyg=rack_locations_xyg,
        shelf_cells_yx=shelf_cells_yx,
        num_shelves=S,
        cell_to_rack=cell_to_rack,
        cell_to_shelfspawn=cell_to_shelfspawn,
        is_goal_grid=is_goal_grid,
        picker_passable=picker_passable,
        field_dist=field_dist,
        field_next_dir=field_next_dir,
    )
