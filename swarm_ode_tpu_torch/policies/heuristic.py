"""FIFO dispatcher policy over a batch of B envs, and the batched rollout.

Counterpart of `swarm_ode_tpu/policies/heuristic.py` at temperature 0
(behavioural target: reference tarware/heuristic.py:26-146):
  * each requested item goes to the closest available AGV (Manhattan
    distance; AGVs plan on the free grid);
  * AGV missions PICKING -> DELIVERING (closest goal) -> RETURNING (closest
    unreserved empty rack cell) -> idle;
  * pickers are zone-partitioned over rack sections and sent to the oldest
    AGV mission in their zone.

The two sequential scans of the JAX policy (over queue items and over AGVs)
are Python loops over batched tensors, each iteration a masked column
update; argmin/argmax return the first index on ties, as in JAX.
`reconstruct_state` and the stochastic (temperature > 0) dispatcher are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.layout import Layout
from swarm_ode_tpu_torch.env.observations import empty_shelf_info
from swarm_ode_tpu_torch.env.pathfinding import INF32
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState
from swarm_ode_tpu_torch.ops.take import grid_at

I32 = torch.int32

# Mission types (reference heuristic.py:12-15)
NONE, PICKING, RETURNING, DELIVERING = 0, 1, 2, 3


@dataclasses.dataclass
class HeuristicState:
    """Dispatcher bookkeeping per env (reference's assigned_agvs /
    assigned_pickers / assigned_items OrderedDicts, heuristic.py:48-50)."""

    agv_mission: torch.Tensor  # (B, Na) int32 mission type
    agv_loc: torch.Tensor  # (B, Na) int32 action id
    agv_item: torch.Tensor  # (B, Na) int32 shelf id reserved by this AGV
    agv_at_loc: torch.Tensor  # (B, Na) bool
    agv_time: torch.Tensor  # (B, Na) int32 mission assignment step
    picker_loc: torch.Tensor  # (B, Np) int32 action id (0 = none)
    timestep: torch.Tensor  # (B,) int32


def init_state(params: EnvParams, B: int) -> HeuristicState:
    Na, Np = params.num_agvs, max(params.num_pickers, 1)
    dev = params.device

    def zeros(n, dtype=I32):
        return torch.zeros(B, n, dtype=dtype, device=dev)

    return HeuristicState(
        agv_mission=zeros(Na),
        agv_loc=zeros(Na),
        agv_item=zeros(Na),
        agv_at_loc=zeros(Na, torch.bool),
        agv_time=zeros(Na),
        picker_loc=zeros(Np),
        timestep=torch.zeros(B, dtype=I32, device=dev),
    )


def picker_zones(layout: Layout, num_pickers: int) -> np.ndarray:
    """(L,) picker index owning each rack cell (action order).

    split_list over rack sections (reference utils/utils.py:9-17 via
    heuristic.py:45-46): the section list chopped into num_pickers
    contiguous chunks of near-equal length.
    """
    n_groups = layout.num_groups
    k, m = divmod(n_groups, num_pickers)
    group_to_picker = np.zeros(n_groups, dtype=np.int32)
    for i in range(num_pickers):
        lo = i * k + min(i, m)
        hi = (i + 1) * k + min(i + 1, m)
        group_to_picker[lo:hi] = i
    return group_to_picker[layout.rack_group_action_order]


def heuristic_policy(
    params: EnvParams,
    zones: torch.Tensor,  # (L,) int32 picker index per rack cell (action order)
    env_state: EnvState,
    h: HeuristicState,
) -> Tuple[torch.Tensor, HeuristicState]:
    """One dispatcher step: returns (macro_actions (B, A) int32, new state)."""
    Na = params.num_agvs
    G, L = params.num_goals, params.num_racks
    dev = params.device
    xy = env_state.agent_xy
    agv_x, agv_y = xy[:, :Na, 0], xy[:, :Na, 1]
    busy = env_state.agent_busy[:, :Na]
    carrying = env_state.agent_carrying[:, :Na] > 0
    t = h.timestep[:, None]
    agv_iota = torch.arange(Na, device=dev)

    # Manhattan distance from every AGV to every action cell (B, Na, T).
    ac = params.action_cells
    dist_all = (agv_y[..., None] - ac[:, 0]).abs() + (agv_x[..., None] - ac[:, 1]).abs()

    # ---- [AGV None -> PICKING]: FIFO queue assignment (heuristic.py:59-77) -
    q_items = env_state.request_queue  # (B, R) shelf ids
    q_idx = (q_items - 1).long()
    q_x = env_state.shelf_xy[..., 0].gather(1, q_idx)
    q_y = env_state.shelf_xy[..., 1].gather(1, q_idx)
    q_rack = grid_at(params.cell_to_rack, q_y, q_x)  # (B, R)
    q_act = torch.where(q_rack >= 0, G + 1 + q_rack, 0)
    q_dist = (agv_y[:, None, :] - q_y[..., None]).abs() + (
        agv_x[:, None, :] - q_x[..., None]
    ).abs()  # (B, R, Na)

    mission, loc, item_arr = h.agv_mission, h.agv_loc, h.agv_item
    time_arr, at_loc = h.agv_time, h.agv_at_loc
    for r in range(q_items.shape[1]):
        item = q_items[:, r, None]
        already = (item_arr == item).any(dim=1)
        available = ~busy & ~carrying & (mission == NONE)
        d = torch.where(available, q_dist[:, r], INF32)
        closest = d.argmin(dim=1, keepdim=True)
        ok = ~already & available.any(dim=1) & (q_act[:, r] > 0)
        sel = ok[:, None] & (agv_iota == closest)
        mission = torch.where(sel, PICKING, mission)
        loc = torch.where(sel, q_act[:, r, None], loc)
        item_arr = torch.where(sel, item, item_arr)
        time_arr = torch.where(sel, t, time_arr)
        at_loc = at_loc & ~sel

    # ---- at_location refresh (heuristic.py:81-82) ----
    loc_cell = ac[(loc - 1).clamp(min=0).long()]
    at_now = (agv_x == loc_cell[..., 1]) & (agv_y == loc_cell[..., 0])
    at_loc = at_loc | ((mission != NONE) & at_now)

    elig = (mission != NONE) & ~busy

    # ---- [PICKING -> DELIVERING] (heuristic.py:88-94) ----
    p2d = elig & (mission == PICKING) & at_loc & carrying
    closest_goal = dist_all[..., :G].argmin(dim=2).to(I32) + 1
    mission = torch.where(p2d, DELIVERING, mission)
    loc = torch.where(p2d, closest_goal, loc)
    time_arr = torch.where(p2d, t, time_arr)
    at_loc = at_loc & ~p2d

    # ---- [DELIVERING -> RETURNING] (heuristic.py:97-108) ----
    # Sequential over AGVs: each choice excludes rack cells reserved by any
    # current mission, including ones assigned earlier in this loop.
    empty = empty_shelf_info(params, env_state) > 0  # (B, L) action order
    d2r = elig & (mission == DELIVERING) & at_loc & carrying
    B = mission.shape[0]
    for i in range(Na):
        rack_slot = torch.where(loc > G, loc - G - 1, L).long()
        reserved = torch.zeros(B, L + 1, dtype=torch.bool, device=dev).scatter(
            1, rack_slot, True
        )[:, :L]
        d = torch.where(empty & ~reserved, dist_all[:, i, G:], INF32)
        best = d.argmin(dim=1, keepdim=True)
        ok = d2r[:, i] & (d.gather(1, best)[:, 0] < INF32)
        # Column updates in place: mission, loc, time_arr and at_loc are
        # fresh tensors from the where/& above, never the caller's.
        mission[:, i] = torch.where(ok, RETURNING, mission[:, i])
        loc[:, i] = torch.where(ok, G + 1 + best[:, 0].to(I32), loc[:, i])
        time_arr[:, i] = torch.where(ok, h.timestep, time_arr[:, i])
        at_loc[:, i] &= ~ok

    # ---- [RETURNING -> None] (heuristic.py:111-113) ----
    done_ret = elig & (mission == RETURNING) & at_loc & ~carrying
    mission = torch.where(done_ret, NONE, mission)
    loc = torch.where(done_ret, 0, loc)
    item_arr = torch.where(done_ret, 0, item_arr)
    at_loc = at_loc & ~done_ret

    # ---- Picker dispatch (heuristic.py:116-127) ----
    picker_loc = h.picker_loc
    if params.num_pickers > 0:
        Np = params.num_pickers
        pick_xy = xy[:, Na:]
        # Pickers whose mission cell is reached: clear (heuristic.py:124-127).
        pcell = ac[(picker_loc - 1).clamp(min=0).long()]
        p_arrived = (
            (picker_loc > 0)
            & (pick_xy[..., 0] == pcell[..., 1])
            & (pick_xy[..., 1] == pcell[..., 0])
        )
        picker_loc = torch.where(p_arrived, 0, picker_loc)

        # Oldest PICKING/RETURNING AGV mission per picker zone: older
        # assignment first, then lower AGV index.
        needs_picker = (mission == PICKING) | (mission == RETURNING)
        m_rack = torch.where(loc > G, loc - G - 1, 0)
        m_zone = torch.where(needs_picker, zones[m_rack.long()], -1)  # (B, Na)
        prio = time_arr * Na + agv_iota.to(I32)
        prio = torch.where(needs_picker, prio, 1 << 30)
        zone_eq = m_zone[:, None, :] == torch.arange(Np, device=dev)[None, :, None]
        prio_p = torch.where(zone_eq, prio[:, None, :], 1 << 30)  # (B, Np, Na)
        best_val, best_agv = prio_p.min(dim=2)
        has_mission = best_val < (1 << 30)
        new_loc = loc.gather(1, best_agv)
        picker_loc = torch.where((picker_loc == 0) & has_mission, new_loc, picker_loc)

    # ---- Actions (heuristic.py:130-133) ----
    agv_actions = torch.where((mission != NONE) & ~busy, loc, 0)
    actions = torch.cat([agv_actions, picker_loc[:, : params.num_pickers]], dim=1)

    new_h = HeuristicState(
        agv_mission=mission,
        agv_loc=loc,
        agv_item=item_arr,
        agv_at_loc=at_loc,
        agv_time=time_arr,
        picker_loc=picker_loc,
        timestep=h.timestep + 1,
    )
    return actions, new_h


def make_policy(params: EnvParams, layout: Layout):
    """Bind the picker zones; returns policy_step(params, env_state, h) ->
    (actions, h)."""
    if params.num_pickers > 0:
        zones_np = picker_zones(layout, params.num_pickers)
    else:
        zones_np = np.zeros(params.num_racks, np.int32)
    zones = torch.from_numpy(zones_np).to(params.device)

    def policy_step(params_, env_state, h):
        return heuristic_policy(params_, zones, env_state, h)

    return policy_step


@dataclasses.dataclass
class Rollout:
    """Result of `heuristic_rollout`. Totals are per env, summed over steps;
    `trace` holds (actions, rewards, info, state) per step when recorded."""

    state: EnvState
    heuristic: HeuristicState
    deliveries: torch.Tensor  # (B,) int32
    clashes: torch.Tensor  # (B,) int32
    stucks: torch.Tensor  # (B,) int32
    replan_overflow: torch.Tensor  # (B,) int32
    trace: List[Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], EnvState]]


def heuristic_rollout(
    params: EnvParams,
    layout: Layout,
    B: int,
    steps: int,
    generator: Optional[torch.Generator] = None,
    state: Optional[EnvState] = None,
    noise: Optional[Sequence[step_mod.StepNoise]] = None,
    record: bool = False,
) -> Rollout:
    """B envs: reset (or start from `state`), then `steps` of dispatcher +
    step. The batched counterpart of `heuristic_episode` and of bench.py's
    rollout. Random draws come from `generator`, or from `noise[t]` at step t.
    Runs where params.device is; no host synchronisation inside the loop."""
    policy = make_policy(params, layout)
    es = state if state is not None else step_mod.reset(params, B, generator)
    h = init_state(params, B)
    dev = params.device

    def zeros():
        return torch.zeros(B, dtype=I32, device=dev)

    deliveries, clashes, stucks, overflow = zeros(), zeros(), zeros(), zeros()
    trace = []
    for t in range(steps):
        actions, h = policy(params, es, h)
        es, rewards, _, info = step_mod.step(
            params, es, actions, generator=generator,
            noise=None if noise is None else noise[t],
        )
        deliveries += info["shelf_deliveries"]
        clashes += info["clashes"]
        stucks += info["stucks"]
        overflow += info["replan_overflow"]
        if record:
            trace.append((actions, rewards, info, es))
    return Rollout(es, h, deliveries, clashes, stucks, overflow, trace)
