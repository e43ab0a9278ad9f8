"""FIFO dispatcher policy over a batch of B envs, and the batched rollout.

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

The module's command line, `python -m swarm_ode_tpu_torch.policies.heuristic
run | parity | render`, is the JAX package's scripts/run_heuristic.py,
eval_parity.py and render_episode.py (`main`).
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.env import rollout
from swarm_ode_tpu_torch.env.layout import Layout, build_layout
from swarm_ode_tpu_torch.env.observations import empty_shelf_info
from swarm_ode_tpu_torch.env.pathfinding import INF32
from swarm_ode_tpu_torch.env.rendering import render_state
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState, make_params
from swarm_ode_tpu_torch.ops.take import grid_at, take_ids
from swarm_ode_tpu_torch.utils.metrics import pick_rate, summarize_traj

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


def heuristic_episode(env, render: bool = False, seed=None):
    """Reference-compatible episode runner (tarware/heuristic.py:26-146).

    `env` is the port's gym-adapter Warehouse (`swarm_ode_tpu_torch.make`).
    The episode is `heuristic_rollout` at B = 1 on the env's device, from a
    generator seeded with `seed`, read back once at its end; the env's own
    state is not touched. Returns (all_infos, global_episode_return,
    episode_returns) like the reference: a list of per-step info dicts of
    Python numbers, a float, and a (A,) float32 array. Unseeded episodes
    differ call to call (the reference draws from the ambient global RNG): a
    process-level counter seeds them."""
    params, layout = env.params, env.layout
    steps = params.max_steps or 500
    if seed is None:
        seed = heuristic_episode._unseeded_counter
        heuristic_episode._unseeded_counter += 1
    gen = torch.Generator(device=params.device).manual_seed(int(seed))
    out = heuristic_rollout(params, layout, 1, steps, gen, record=True)
    if render:
        render_state(params, layout, out.state, mode="human")
    rewards = torch.stack([r[0] for _, r, _, _ in out.trace]).cpu().numpy()  # (T, A)
    infos = {
        k: torch.stack([info[k][0] for _, _, info, _ in out.trace]).cpu().numpy()
        for k in out.trace[0][2]
    }
    all_infos = [
        {k: v[t].tolist() if v[t].ndim else v[t].item() for k, v in infos.items()}
        for t in range(steps)
    ]
    return all_infos, float(rewards.sum()), rewards.sum(axis=0)


heuristic_episode._unseeded_counter = 0


# ---------------------------------------------------------------------------
# The dispatcher's command lines: scripts/run_heuristic.py (`run`),
# scripts/eval_parity.py (`parity`) and scripts/render_episode.py (`render`).

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
TINY = "tarware-tiny-3agvs-2pickers-partialobs-v1"

# The per-episode stat line of scripts/run_heuristic.py:60-67, and a pattern
# that reads either package's line back.
_NUM = r"(-?[0-9.]+)"
STAT_LINE = re.compile(
    rf"Episode (?P<episode>\d+): \| \[Overall Pick Rate={_NUM}\]"
    rf"\| \[Global return={_NUM}\]\| \[Total shelf deliveries={_NUM}\]"
    rf"\| \[Total clashes={_NUM}\]\| \[Total stuck={_NUM}\] \| \[FPS = {_NUM}\]$"
)
STAT_FIELDS = ("overall_pick_rate", "global_episode_return", "total_deliveries",
               "total_clashes", "total_stuck", "fps")

# Reference xlsx statistics (mean, min, max over 30 episodes; SURVEY.md §6),
# scripts/eval_parity.py's REFERENCE.
PARITY_REFERENCE = {
    "overall_pick_rate": (115.97, 84.96, 133.92),
    "global_episode_return": (82.29, 57.5, 97.2),
    "total_deliveries": (80.53, 59, 93),
    "total_clashes": (170.77, 94, 642),
    "total_stuck": (19.30, 5, 110),
}


def stat_line(episode: int, s: Dict, seconds: float) -> str:
    """scripts/run_heuristic.py's line for one episode's summary `s`
    (`summarize_traj`) that took `seconds` of wall time."""
    return (
        f"Episode {episode}: | [Overall Pick Rate={s['overall_pick_rate']:.2f}]"
        f"| [Global return={s['global_episode_return']:.2f}]"
        f"| [Total shelf deliveries={s['total_deliveries']:.2f}]"
        f"| [Total clashes={s['total_clashes']:.2f}]"
        f"| [Total stuck={s['total_stuck']:.2f}]"
        f" | [FPS = {s['episode_length'] / seconds:.2f}]"
    )


def run_episode(params: EnvParams, layout: Layout, steps: int,
                generator: Optional[torch.Generator] = None, state: Optional[EnvState] = None,
                noise: Optional[Sequence[step_mod.StepNoise]] = None):
    """One env (B = 1): a reset from `generator` (or `state`), then `steps`
    of dispatcher + step with no host synchronisation, the trajectory read
    back once at the end. Returns (rewards (T, A), info {key: (T, ...)}) as
    numpy arrays, what `utils.metrics.summarize_traj` takes. Draws come from
    `generator`, or from `noise[t]` at step t."""
    es = state if state is not None else step_mod.reset(params, 1, generator)
    _, _, (rewards, _, info) = rollout(params, make_policy(params, layout), init_state(params, 1),
                                       es, steps, generator, noise)
    return rewards[0].cpu().numpy(), {k: v[0].cpu().numpy() for k, v in info.items()}


def parity_totals(params: EnvParams, layout: Layout, B: int, steps: int,
                  generator: Optional[torch.Generator] = None, state: Optional[EnvState] = None,
                  noise: Optional[Sequence[step_mod.StepNoise]] = None) -> Dict[str, np.ndarray]:
    """scripts/eval_parity.py's per-episode sums: B envs in one batched
    rollout of `steps` steps, summed per env on the device (the return over
    agents and steps, deliveries, clashes, stucks; and the replan overflow)
    and read back once, as (B,) numpy arrays."""
    out = heuristic_rollout(params, layout, B, steps, generator, state, noise)
    sums = {"global_episode_return": out.returns, "total_deliveries": out.deliveries,
            "total_clashes": out.clashes, "total_stuck": out.stucks,
            "replan_overflow": out.replan_overflow}
    return {k: v.cpu().numpy() for k, v in sums.items()}


def parity_report(totals: Dict[str, np.ndarray], steps: int) -> Tuple[List[str], Dict]:
    """The reference's distribution beside ours: scripts/eval_parity.py's
    table (lines) and the `detail` of its JSON line."""
    ours = dict(totals, overall_pick_rate=pick_rate(1, steps) * totals["total_deliveries"])
    lines = [f"{'metric':26s} {'reference mean (min-max)':>28s} {'ours mean (min-max)':>26s}"]
    report = {}
    for k, (rm, rlo, rhi) in PARITY_REFERENCE.items():
        v = ours[k].astype(np.float64)
        lines.append(
            f"{k:26s} {rm:10.2f} ({rlo:.1f}-{rhi:.1f})"
            f"{'':6s}{v.mean():10.2f} ({v.min():.1f}-{v.max():.1f})"
        )
        report[k] = {
            "reference": {"mean": rm, "min": rlo, "max": rhi},
            "ours": {"mean": round(float(v.mean()), 2), "min": round(float(v.min()), 2),
                     "max": round(float(v.max()), 2)},
        }
    return lines, report


def parity_config(env_id: str, replan_rejoin: bool = False, row_frac: Optional[float] = None):
    """The env config `parity` runs: `env_id`'s, with scripts/eval_parity.py's
    overrides of the replan rejoin and the compaction budget."""
    cfg = EnvConfig.from_env_id(env_id)
    if replan_rejoin or row_frac is not None:
        cfg = dataclasses.replace(
            cfg, replan_rejoin=replan_rejoin or cfg.replan_rejoin,
            replan_row_frac=cfg.replan_row_frac if row_frac is None else row_frac,
        )
    return cfg


def render_episode(params: EnvParams, layout: Layout, steps: int, every: int = 1,
                   mode: str = "rgb_array", generator: Optional[torch.Generator] = None,
                   state: Optional[EnvState] = None,
                   noise: Optional[Sequence[step_mod.StepNoise]] = None) -> list:
    """One env (B = 1) driven by the dispatcher for up to `steps` steps,
    `render_state` of every `every`-th state from the reset on (before its
    step), stopping after the step that ends the episode: the host loop of
    scripts/render_episode.py (`done` read each step). Returns the frames
    (None each in mode "human", drawn on screen)."""
    policy = make_policy(params, layout)
    es = state if state is not None else step_mod.reset(params, 1, generator)
    h = init_state(params, 1)
    frames = []
    for t in range(steps):
        if t % every == 0:
            frames.append(render_state(params, layout, es, mode=mode))
        actions, h = policy(params, es, h)
        es, _, done, _ = step_mod.step(params, es, actions, generator=generator,
                                       noise=None if noise is None else noise[t])
        if bool(done[0]):
            break
    return frames


def _env(cfg, device: str):
    """(layout, params) of `cfg` on `device`; the card is required unless
    the caller asks for the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this command runs on the card (--device cuda) and none is "
                           "available; pass --device cpu to run on the CPU")
    layout = build_layout(cfg)
    return layout, make_params(cfg, layout, device)


def _run(args) -> List[Dict]:
    cfg = EnvConfig.from_env_id(args.env_id)
    layout, params = _env(cfg, args.device)
    steps = cfg.max_steps or 500
    if args.render:
        gen = torch.Generator(device=params.device).manual_seed(args.seed)
        render_episode(params, layout, steps, mode="human", generator=gen)
        return []
    episodes = []
    for ep in range(args.num_episodes):
        gen = torch.Generator(device=params.device).manual_seed(args.seed + ep)
        start = time.perf_counter()
        rewards, info = run_episode(params, layout, steps, gen)
        seconds = time.perf_counter() - start
        s = summarize_traj(rewards, info)
        print(stat_line(ep, s, seconds), flush=True)
        episodes.append(dict(s, seconds=seconds,
                             replan_overflow=int(info["replan_overflow"].sum())))
    return episodes


def _parity(args) -> Dict[str, np.ndarray]:
    import json

    cfg = parity_config(args.env_id, args.replan_rejoin, args.row_frac)
    layout, params = _env(cfg, args.device)
    steps = cfg.max_steps or 500
    gen = torch.Generator(device=params.device).manual_seed(args.seed)
    totals = parity_totals(params, layout, args.episodes, steps, gen)
    lines, report = parity_report(totals, steps)
    print("\n".join(lines))
    print(json.dumps({"metric": "parity_medium_30ep", "detail": report}), flush=True)
    return totals


def _render(args) -> int:
    import matplotlib  # noqa: F401  (render_state's; fail before any env work)
    from PIL import Image

    cfg = EnvConfig.from_env_id(args.env_id)
    layout, params = _env(cfg, args.device)
    gen = torch.Generator(device=params.device).manual_seed(args.seed)
    frames = [Image.fromarray(f)
              for f in render_episode(params, layout, args.steps, args.every, generator=gen)]
    frames[0].save(args.out, save_all=True, append_images=frames[1:], duration=120, loop=0)
    print(f"wrote {args.out} ({len(frames)} frames)")
    return len(frames)


def main(argv=None):
    """The dispatcher's command lines, each on `--device` (the card by
    default; without one they raise). `run`: scripts/run_heuristic.py,
    seeded episodes at B = 1 with its per-episode stat line (or a live view
    with --render). `parity`: scripts/eval_parity.py, `--episodes` seeded
    episodes as one batched rollout beside the reference's distribution.
    `render`: scripts/render_episode.py, an episode as an animated GIF
    (needs matplotlib and PIL). Returns what the command computed: `run`
    each episode's summary, `parity` the per-episode sums, `render` the
    number of frames."""
    import argparse

    fmt = argparse.ArgumentDefaultsHelpFormatter
    p = argparse.ArgumentParser(description=main.__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("run", formatter_class=fmt, help="heuristic evaluation episodes")
    r.add_argument("--num_episodes", type=int, default=10)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--render", action="store_true")
    r.add_argument("--env_id", default=MEDIUM)
    q = sub.add_parser("parity", formatter_class=fmt,
                       help="the reference's 30-episode distribution beside ours")
    q.add_argument("--env_id", default=MEDIUM)
    q.add_argument("--episodes", type=int, default=30)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--replan_rejoin", action="store_true",
                   help="measure the replan-rejoin throughput lever's behavior distribution "
                        "(config.py replan_rejoin)")
    q.add_argument("--row_frac", type=float, default=None,
                   help="override the batched-replan compaction budget (config.py "
                        "replan_row_frac)")
    v = sub.add_parser("render", formatter_class=fmt, help="an episode as an animated GIF")
    v.add_argument("--env_id", default=TINY)
    v.add_argument("--steps", type=int, default=120)
    v.add_argument("--every", type=int, default=2, help="render every Nth step")
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--out", default="episode.gif")
    for s in (r, q, v):
        s.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args(argv)
    return {"run": _run, "parity": _parity, "render": _render}[args.command](args)


if __name__ == "__main__":
    main()
