"""FIFO dispatcher policy over a batch of B envs, and the batched rollout.

Frozen copy, for the benchmark's reference, of the program's `policies/heuristic.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

Counterpart of `swarm_ode_tpu/policies/heuristic.py` (behavioural target:
reference tarware/heuristic.py:26-146):
  * each requested item goes to the closest available AGV (Manhattan
    distance; AGVs plan on the free grid);
  * AGV missions PICKING -> DELIVERING (closest goal) -> RETURNING (closest
    unreserved empty rack cell) -> idle;
  * pickers are zone-partitioned over rack sections and sent to the oldest
    AGV mission in their zone.

The two sequential scans of the JAX policy (over queue items and over AGVs)
are Python loops over batched tensors, each iteration a masked column
update; argmin/argmax return the first index on ties, as in JAX.

At temperature > 0 every AGV choice site samples proportional to
exp(-distance / T) (the stochastic-expert ablation). JAX draws the Gumbel
noise from a PRNG key per step; here one step's draws are a `DispatchNoise`,
drawn from a `torch.Generator` or passed in (the tests pass JAX's own).
`reconstruct_state` re-derives the dispatcher's bookkeeping from the env
state alone, which makes the stateless expert DAgger labels with.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import step as step_mod
from .layout import Layout, build_layout
from .observations import empty_shelf_info
from .pathfinding import INF32
from .state import EnvParams, EnvState, make_params
from .take import grid_at, take_ids

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


@dataclasses.dataclass
class DispatchNoise:
    """One stochastic dispatcher step's float32 Gumbel draws per env: the
    counterparts of the JAX policy's `split(key, 3)` streams.

    assign: (B, R, Na), one (Na,) draw per queue item (JAX's
      `split(k_assign, R)`);
    goal: (B, Na, G), the goal choice (`gumbel(k_goal, (Na, G))`);
    ret: (B, Na, L), one (L,) draw per AGV (`split(k_ret, Na)`).
    """

    assign: torch.Tensor
    goal: torch.Tensor
    ret: torch.Tensor


def draw_dispatch_noise(params: EnvParams, B: int, generator: torch.Generator) -> DispatchNoise:
    """One step's dispatcher draws from `generator` (on params.device)."""
    Na, R = params.num_agvs, params.request_queue_size
    dev = params.device
    return DispatchNoise(
        assign=step_mod.draw_gumbel((B, R, Na), generator, dev),
        goal=step_mod.draw_gumbel((B, Na, params.num_goals), generator, dev),
        ret=step_mod.draw_gumbel((B, Na, params.num_racks), generator, dev),
    )


def _sampled_argmin(d: torch.Tensor, g: torch.Tensor, temperature) -> torch.Tensor:
    """argmin of d over its last axis, Gumbel-perturbed by `g` (d's shape):
    index i with probability proportional to exp(-d_i / T) over the valid
    (d < INF32) entries; the first maximum on ties, as jnp.argmax.

    `temperature`: a float, or a 0-d float32 tensor on d's device. A float
    is made such a tensor: CUDA divides by a Python scalar as a product with
    its reciprocal, which can differ from the quotient in the last bit."""
    if not isinstance(temperature, torch.Tensor):
        temperature = torch.full((), temperature, dtype=torch.float32, device=d.device)
    scores = torch.where(d < INF32, -d / temperature + g, -torch.inf)
    return scores.argmax(dim=-1)


def heuristic_policy(
    params: EnvParams,
    zones: torch.Tensor,  # (L,) int32 picker index per rack cell (action order)
    env_state: EnvState,
    h: HeuristicState,
    noise: Optional[DispatchNoise] = None,
    temperature: float = 0.0,
) -> Tuple[torch.Tensor, HeuristicState]:
    """One dispatcher step: returns (macro_actions (B, A) int32, new state).

    temperature = 0 (default): the reference's deterministic dispatcher.
    temperature > 0 (requires `noise`): queue assignment, goal choice and
    return-cell choice sample proportional to exp(-distance / T)
    (`_sampled_argmin`; the goal choice unmasked, as in JAX). Mission
    structure, FIFO order and picker zoning are unchanged."""
    Na = params.num_agvs
    G, L = params.num_goals, params.num_racks
    dev = params.device
    stochastic = temperature is not None and temperature > 0
    if stochastic:
        if noise is None:
            raise ValueError("temperature>0 requires dispatch noise")
        temp = torch.full((), temperature, dtype=torch.float32, device=dev)
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
        if stochastic:
            closest = _sampled_argmin(d, noise.assign[:, r], temp)[:, None]
        else:
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
    if stochastic:
        goal_scores = -dist_all[..., :G] / temp + noise.goal
        closest_goal = goal_scores.argmax(dim=2).to(I32) + 1
    else:
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
        if stochastic:
            best = _sampled_argmin(d, noise.ret[:, i], temp)[:, None]
        else:
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


def _zones(params: EnvParams, layout: Layout) -> torch.Tensor:
    if params.num_pickers > 0:
        zones_np = picker_zones(layout, params.num_pickers)
    else:
        zones_np = np.zeros(params.num_racks, np.int32)
    return torch.from_numpy(zones_np).to(params.device)


def reconstruct_state(params: EnvParams, env_state: EnvState) -> HeuristicState:
    """HeuristicState re-derived from the env state alone (JAX
    `reconstruct_state`): the mission phase from `agent_busy`,
    `agent_carrying` and `agent_has_delivered`, the mission cell from
    `agent_target`. heuristic_policy(reconstruct_state(s), s) labels any
    state with the dispatcher's action, the expert oracle DAgger needs.
    Assignment timestamps are all zero, so the picker "oldest mission first"
    tie-break degrades to lowest-AGV-index order.

    The shelf on each rack cell comes from a scatter of every shelf's id to
    its cell, carried shelves included. A carrier standing on a rack cell
    that holds another shelf writes that cell twice: the JAX package's
    `.at[].set` on the CPU keeps the last write, the highest shelf id, and
    so does the "amax" scatter here (on the CPU and the card alike)."""
    Na = params.num_agvs
    G, L = params.num_goals, params.num_racks
    B = env_state.batch
    busy = env_state.agent_busy[:, :Na]
    carrying = env_state.agent_carrying[:, :Na] > 0
    delivered = env_state.agent_has_delivered[:, :Na]
    target = env_state.agent_target[:, :Na]

    mission = torch.where(
        carrying & ~delivered,
        torch.where(busy, DELIVERING, PICKING),
        torch.where(
            carrying & delivered,
            torch.where(busy, RETURNING, DELIVERING),
            torch.where(busy, PICKING, NONE),
        ),
    ).to(I32)
    # Idle carrying agents sit where their last leg ended: at_loc fires the
    # phase transitions that hand them their next destination.
    at_loc = ~busy & carrying
    loc = torch.where(busy, target, 0).to(I32)

    # Claimed queue items: the shelf a busy pickup-bound AGV heads to.
    sx, sy = env_state.shelf_xy[..., 0], env_state.shelf_xy[..., 1]
    rack = grid_at(params.cell_to_rack, sy, sx)  # (B, S)
    slot = torch.where(rack >= 0, rack, L).long()
    ids = torch.arange(1, rack.shape[1] + 1, dtype=I32, device=rack.device).expand_as(rack)
    rack_shelf = torch.zeros(B, L + 1, dtype=I32, device=rack.device).scatter_reduce(
        1, slot, ids, "amax"
    )[:, :L]
    tgt_rack = torch.where(target > G, target - G - 1, 0)
    heading_to_pick = busy & ~carrying & (target > G)
    item = torch.where(
        carrying, env_state.agent_carrying[:, :Na],
        torch.where(heading_to_pick, take_ids(rack_shelf, tgt_rack), 0),
    ).to(I32)

    Np = max(params.num_pickers, 1)
    p_busy = env_state.agent_busy[:, Na:]
    picker_loc = torch.where(p_busy, env_state.agent_target[:, Na:], 0).to(I32)
    pad = torch.zeros(B, Np - picker_loc.shape[1], dtype=I32, device=rack.device)
    picker_loc = torch.cat([picker_loc, pad], dim=1)[:, :Np]

    return HeuristicState(
        agv_mission=mission,
        agv_loc=loc,
        agv_item=item,
        agv_at_loc=at_loc,
        agv_time=torch.zeros(B, Na, dtype=I32, device=rack.device),
        picker_loc=picker_loc,
        timestep=env_state.cur_steps,
    )


def make_stateless_expert(params: EnvParams, layout: Layout):
    """Expert oracle for DAgger: expert(params, env_state) -> the
    dispatcher's macro actions (B, A), no threaded bookkeeping."""
    zones = _zones(params, layout)

    def expert(params_, env_state):
        actions, _ = heuristic_policy(params_, zones, env_state,
                                      reconstruct_state(params_, env_state))
        return actions

    return expert


def make_policy(params: EnvParams, layout: Layout, temperature: float = 0.0):
    """Bind the picker zones; returns policy_step(params, env_state, h) ->
    (actions, h).

    With temperature > 0 the step takes one more argument, the step's
    draws: policy_step(params, env_state, h, noise), `noise` a
    `DispatchNoise` or a `torch.Generator` to draw one from (JAX's policy
    takes a PRNG key there)."""
    zones = _zones(params, layout)

    if temperature and temperature > 0:

        def policy_step_stoch(params_, env_state, h, noise):
            if isinstance(noise, torch.Generator):
                noise = draw_dispatch_noise(params_, env_state.batch, noise)
            return heuristic_policy(params_, zones, env_state, h, noise=noise,
                                    temperature=temperature)

        return policy_step_stoch

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
    returns: torch.Tensor  # (B,) float32, rewards summed over agents and steps


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
    returns = torch.zeros(B, dtype=torch.float32, device=dev)
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
        returns += rewards.sum(1)
        if record:
            trace.append((actions, rewards, info, es))
    return Rollout(es, h, deliveries, clashes, stucks, overflow, trace, returns)
