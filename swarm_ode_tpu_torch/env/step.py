"""Warehouse simulation step over a batch of B envs.

Counterpart of `swarm_ode_tpu/env/step.py` (reset :166, step :239), with the
same phases and rules: attribute macro actions -> resolve move conflicts ->
resolve stuck agents -> execute micro actions -> process deliveries ->
termination (reference warehouse.py:668-704). See the JAX module's docstring
for the semantics; this file keeps its order of operations so that integer
state and float rewards come out bit for bit the same.

Differences of form only:
  * every tensor carries a leading batch dimension B (no vmap);
  * occupancy queries gather from (B, H*W) id grids (env/queries.py);
  * the scan over goals in Phase 5 is a Python loop over batched tensors;
  * random draws come from a `torch.Generator`, or are passed in as
    `StepNoise` (the tests pass the JAX package's own draws).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from swarm_ode_tpu_torch.definitions import (
    DELIVERY_REWARD,
    FIXING_CLASH_TIME,
    HANDOFF_REWARD_GLOBAL,
    HANDOFF_REWARD_INDIVIDUAL,
    STEP_PENALTY,
    STUCK_THRESHOLD,
    Action,
    AgentType,
    Direction,
    RewardType,
)
from swarm_ode_tpu_torch.env.pathfinding import INF32, replan_query
from swarm_ode_tpu_torch.env.queries import cell_max, grid_lookup, id_flags, occupant_grid
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState, agent_class
from swarm_ode_tpu_torch.ops.take import grid_at, take_ids, take_many

I32 = torch.int32

# Direction value -> index on the clockwise wheel [UP, RIGHT, DOWN, LEFT]
_DIR_TO_WHEEL = (0, 2, 3, 1)
_WHEEL_TO_DIR = (0, 3, 1, 2)
# turn difference (src_wheel - dst_wheel) % 4 -> micro action
# (reference utils/utils.py:54-64)
_TURN_TO_ACTION = (Action.FORWARD, Action.LEFT, Action.RIGHT, Action.RIGHT)
# Direction -> (dx, dy) displacement
_DIR_DX = (0, 0, -1, 1)
_DIR_DY = (-1, 1, 0, 0)


@functools.lru_cache(maxsize=None)
def _table(values: tuple, device: torch.device) -> torch.Tensor:
    """A small constant int32 lookup table on `device` (built once)."""
    return torch.tensor([int(v) for v in values], dtype=I32, device=device)


def _lookup(values: tuple, idx: torch.Tensor) -> torch.Tensor:
    return _table(values, idx.device)[idx.long()]


@dataclasses.dataclass
class StepNoise:
    """The random draws of one step.

    break_r: (B, A) int32 in [0, 4), the deadlock-break escape move (read
      only when params.deadlock_break > 0; may be None otherwise).
    delivery_gumbel: (B, G, S) float32 Gumbel noise, one (S,) draw per goal,
      that picks the replacement request of a delivered shelf.
    """

    break_r: Optional[torch.Tensor]
    delivery_gumbel: torch.Tensor


def draw_noise(params: EnvParams, B: int, generator: torch.Generator) -> StepNoise:
    """One step's draws from `generator` (on params.device)."""
    dev = params.device
    break_r = None
    if params.deadlock_break:
        break_r = torch.randint(
            0, 4, (B, params.num_agents), generator=generator, device=dev, dtype=I32
        )
    gumbel = draw_gumbel((B, params.num_goals, params.num_shelves), generator, dev)
    return StepNoise(break_r=break_r, delivery_gumbel=gumbel)


def draw_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel float32 noise, -log(-log(u)) with u uniform and
    clamped to the smallest normal float32 (jax.random.gumbel's rule)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def micro_toward(cur_dir: torch.Tensor, move_dir: torch.Tensor) -> torch.Tensor:
    """Next micro action to end up moving in `move_dir`
    (reference utils/utils.py:37-64)."""
    diff = (_lookup(_DIR_TO_WHEEL, cur_dir) - _lookup(_DIR_TO_WHEEL, move_dir)) % 4
    return _lookup(_TURN_TO_ACTION, diff)


def _picker_field_lookup(params: EnvParams, tgt_idx, y, x):
    """Picker static field at (tgt_idx, y, x) for every agent: (dist, next_dir)
    int32. Rows of AGVs hold a picker's value too; callers mask by class."""
    H, W = params.grid_h, params.grid_w
    flat = (tgt_idx.long() * H + y.long()) * W + x.long()
    d = params.field_dist_picker.reshape(-1)[flat]
    nd = params.field_next_dir_picker.reshape(-1)[flat].to(I32)
    return d, nd


def static_dist_at(params: EnvParams, tgt_idx, cls, x, y):
    """Static planning distance from (x, y) to each agent's target: Manhattan
    for free-grid agents, the precomputed highway field for pickers."""
    tgt = params.action_cells[tgt_idx.long()]
    man = (tgt[..., 0] - y).abs() + (tgt[..., 1] - x).abs()
    if params.num_pickers == 0:
        return man
    d_pick, _ = _picker_field_lookup(params, tgt_idx, y, x)
    return torch.where(cls == 0, man, d_pick)


def static_dist_nextdir(params: EnvParams, tgt_idx, cls, xy):
    """Static-field distance and next hop per agent. Closed form for
    free-grid agents (vertical first, like the BFS field's neighbour
    preference), table lookup for pickers."""
    x, y = xy[..., 0], xy[..., 1]
    tgt = params.action_cells[tgt_idx.long()]
    ty, tx = tgt[..., 0], tgt[..., 1]
    man = (ty - y).abs() + (tx - x).abs()
    horiz = torch.where(tx < x, int(Direction.LEFT), int(Direction.RIGHT)).to(I32)
    nd_free = torch.where(
        ty < y, int(Direction.UP), torch.where(ty > y, int(Direction.DOWN), horiz)
    )
    nd_free = torch.where(man == 0, -1, nd_free)
    if params.num_pickers == 0:
        return man, nd_free
    d_pick, nd_pick = _picker_field_lookup(params, tgt_idx, y, x)
    return torch.where(cls == 0, man, d_pick), torch.where(cls == 0, nd_free, nd_pick)


def reset(params: EnvParams, B: int, generator: torch.Generator) -> EnvState:
    """B fresh episodes (reference warehouse.py:621-666): agents on distinct
    random highway cells facing random directions, a request queue of
    distinct random shelves, every shelf on its spawn cell."""
    dev = params.device
    A, S, R = params.num_agents, params.num_shelves, params.request_queue_size
    n_hw = params.highway_cells.shape[0]
    loc_ids = torch.rand(B, n_hw, generator=generator, device=dev).argsort(dim=1)[:, :A]
    agent_xy = params.highway_cells[loc_ids].flip(-1).contiguous()  # (B, A, 2) (x, y)
    agent_dir = torch.randint(0, 4, (B, A), generator=generator, device=dev, dtype=I32)
    picks = torch.rand(B, S, generator=generator, device=dev).argsort(dim=1)[:, :R]
    request_queue = (picks + 1).to(I32)
    shelf_xy = params.shelf_cells.flip(-1).expand(B, S, 2).contiguous()

    def zeros(dtype=I32):
        return torch.zeros(B, A, dtype=dtype, device=dev)

    return EnvState(
        agent_xy=agent_xy,
        agent_dir=agent_dir,
        agent_busy=zeros(torch.bool),
        agent_target=zeros(),
        agent_carrying=zeros(),
        agent_fixing_clash=zeros(),
        agent_replan=zeros(torch.bool),
        agent_has_delivered=zeros(torch.bool),
        agent_req_action=torch.full((B, A), int(Action.NOOP), dtype=I32, device=dev),
        stuck_count=zeros(),
        stuck_xy=agent_xy.clone(),
        agent_break=zeros(),
        shelf_xy=shelf_xy,
        request_queue=request_queue,
        cur_steps=torch.zeros(B, dtype=I32, device=dev),
        cur_inactive=torch.zeros(B, dtype=I32, device=dev),
    )


def _replan_dist_nextdir(params: EnvParams, state: EnvState, occupied, targets_yx, cls,
                         xy, need):
    """(d, nd, dyn_ok, overflow) at each agent's own cell per
    config.replan_mode. `need` marks rows whose results this step consumes
    (drives the batched compaction budget)."""
    B, A = state.agent_dir.shape
    x, y = xy[..., 0], xy[..., 1]
    if params.replan_mode == "bfs":
        d, nd, ovf = replan_query(params, occupied, targets_yx, xy.flip(-1), cls, need)
        return d, nd, d < INF32, ovf
    # Static-field fallback ('off' / 'greedy'): distance from the static
    # field; 'greedy' biases the next hop toward unoccupied neighbours.
    no_overflow = torch.zeros(B, dtype=I32, device=xy.device)
    tgt_idx = (state.agent_target - 1).clamp(min=0)
    sdist, snd = static_dist_nextdir(params, tgt_idx, cls, xy)
    if params.replan_mode == "off":
        return sdist, snd, sdist < INF32, no_overflow
    H, W = params.grid_h, params.grid_w
    occ_flat = occupied.reshape(B, H * W)
    best_score = torch.full((B, A), 1 << 30, dtype=I32, device=xy.device)
    best_dir = snd
    for d in range(4):
        nx = (x + _DIR_DX[d]).clamp(0, W - 1)
        ny = (y + _DIR_DY[d]).clamp(0, H - 1)
        in_bounds = (x + _DIR_DX[d] == nx) & (y + _DIR_DY[d] == ny)
        nd_dist = static_dist_at(params, tgt_idx, cls, nx, ny)
        occ = grid_lookup(occ_flat, nx, ny, W)
        score = nd_dist + occ.to(I32) * 1000
        score = torch.where(in_bounds, score, 1 << 30)
        take = score < best_score
        best_score = torch.where(take, score, best_score)
        best_dir = torch.where(take, d, best_dir)
    return sdist, best_dir, sdist < INF32, no_overflow


def step(
    params: EnvParams,
    state: EnvState,
    macro_actions: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    noise: Optional[StepNoise] = None,
) -> Tuple[EnvState, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One simulation step of B envs.

    Args:
      macro_actions: (B, A) int in [0, num_actions); 0 = noop, 1..G goals,
        G+1.. rack cells (reference action_id_to_coords_map).
      generator: source of this step's random draws when `noise` is None.
      noise: this step's draws, given explicitly.

    Returns:
      (new_state, rewards (B, A) float32, done (B,) bool, info dict of (B,)
      or (B, A) tensors)
    """
    B, A = state.agent_dir.shape
    H, W = params.grid_h, params.grid_w
    S = params.num_shelves
    dev = params.device
    if noise is None:
        if generator is None:
            raise ValueError("step needs a generator or explicit noise")
        noise = draw_noise(params, B, generator)
    aidx = torch.arange(A, device=dev)
    cls = agent_class(params)
    is_picker = params.agent_type == AgentType.PICKER
    is_loader = ~is_picker  # AGV or AGENT: can toggle-load
    is_agv = params.agent_type == AgentType.AGV
    is_agent = params.agent_type == AgentType.AGENT

    xy = state.agent_xy
    x, y = xy[..., 0], xy[..., 1]
    on_grid = ~id_flags(state.agent_carrying, S)  # shelf sits on its cell

    # Occupancy layers at the start of the step (reference _recalc_grid).
    shelf_grid = occupant_grid(state.shelf_xy, on_grid, H, W)
    agv_grid = occupant_grid(xy, is_loader, H, W)
    picker_grid = occupant_grid(xy, is_picker, H, W)
    carried_grid = cell_max(xy, state.agent_carrying, H, W)

    def shelf_at(qx, qy):
        return grid_lookup(shelf_grid, qx, qy, W)

    def agv_at(qx, qy):
        return grid_lookup(agv_grid, qx, qy, W)

    def picker_at(qx, qy):
        return grid_lookup(picker_grid, qx, qy, W)

    # Obstacle bitmap for the BFS replanner: cells holding any agent.
    occupied = ((agv_grid > 0) | (picker_grid > 0)).view(B, H, W)

    # ---------------- Phase 1a: target assignment (warehouse.py:358-376) ----
    fixing = (state.agent_fixing_clash - 1).clamp(min=0)
    was_busy = state.agent_busy
    macro = macro_actions.to(I32)
    tgt_idx_macro = (macro - 1).clamp(min=0)
    start_dist = static_dist_at(params, tgt_idx_macro, cls, x, y)
    can_start = (~was_busy) & (macro != 0) & (start_dist > 0) & (start_dist < INF32)
    target = torch.where(was_busy, state.agent_target, 0)
    target = torch.where(can_start, macro, target)
    busy = was_busy | can_start
    replan = state.agent_replan & was_busy

    tgt_idx = (target - 1).clamp(min=0)
    tgt_cell = params.action_cells[tgt_idx.long()]  # (B, A, 2) (y, x)
    tgt_y, tgt_x = tgt_cell[..., 0], tgt_cell[..., 1]

    # ---------------- Phase 1b statics + dynamic replan fields --------------
    s_dist, s_nd = static_dist_nextdir(params, tgt_idx, cls, xy)
    # Rows whose dynamic values this step can consume (the BFS compaction):
    # replan followers, potential clash triggers (an agent stands on the
    # forward cell) and stuck candidates.
    fwd_x = x + _lookup(_DIR_DX, state.agent_dir)
    fwd_y = y + _lookup(_DIR_DY, state.agent_dir)
    fwd_occ = (
        (x[:, None, :] == fwd_x[:, :, None]) & (y[:, None, :] == fwd_y[:, :, None])
    ).any(dim=2)
    need = replan | (busy & (fwd_occ | (state.stuck_count > STUCK_THRESHOLD)))
    dyn_dist_at, dyn_nd_at, dyn_ok, replan_overflow = _replan_dist_nextdir(
        params, state.replace(agent_target=target), occupied, tgt_cell, cls, xy, need
    )
    use_dyn = replan
    d = torch.where(use_dyn, dyn_dist_at, s_dist)
    nd = torch.where(use_dyn, dyn_nd_at, s_nd)
    d = torch.where(busy, d, 0)

    arrived = busy & (d == 0)
    req = torch.full((B, A), int(Action.NOOP), dtype=I32, device=dev)
    move_req = micro_toward(state.agent_dir, nd.clamp(min=0))
    moving_now = busy & (d > 0) & (d < INF32) & (nd >= 0)
    req = torch.where(moving_now, move_req, req)
    req = torch.where(arrived & is_loader, int(Action.TOGGLE_LOAD), req)
    # Pickers that finished their path simply become idle (warehouse.py:382-383).
    busy = busy & ~(arrived & is_picker)

    # Distance-travelled counters (warehouse.py:385-387).
    followed = was_busy & ~arrived & (d < INF32)
    agvs_distance = (followed & is_agv).sum(1, dtype=I32)
    pickers_distance = (followed & is_picker).sum(1, dtype=I32)

    # Near-target logic for previously-busy agents (warehouse.py:388-404).
    near = was_busy & (d == 1)
    tgt_shelf = shelf_at(tgt_x, tgt_y)
    abort_unload = near & (state.agent_carrying > 0) & (tgt_shelf > 0)
    req = torch.where(abort_unload, int(Action.NOOP), req)
    busy = busy & ~abort_unload

    # Picker waits next to the shelf until its AGV is toggling there
    # (warehouse.py:393-404).
    tgt_agv = agv_at(tgt_x, tgt_y)
    tgt_agv_req = torch.where(
        tgt_agv > 0, take_ids(req, (tgt_agv - 1).clamp(min=0)), int(Action.NOOP)
    )
    agv_toggling = (tgt_agv > 0) & (tgt_agv_req == Action.TOGGLE_LOAD)
    picker_near = near & is_picker
    req = torch.where(picker_near & ~agv_toggling, int(Action.NOOP), req)
    reset_stuck = can_start | (picker_near & agv_toggling)

    stuck_count = torch.where(reset_stuck, 0, state.stuck_count)
    stuck_xy = torch.where(reset_stuck[..., None], xy, state.stuck_xy)

    # ---------------- Phase 1c: deadlock-break escape (option) --------------
    agent_break = state.agent_break
    if params.deadlock_break:
        esc = agent_break > 0
        ef_x = x + _lookup(_DIR_DX, state.agent_dir)
        ef_y = y + _lookup(_DIR_DY, state.agent_dir)
        inb = (ef_x >= 0) & (ef_x < W) & (ef_y >= 0) & (ef_y < H)
        fwd_hw = inb & grid_at(params.highway, ef_y.clamp(0, H - 1), ef_x.clamp(0, W - 1))
        r = noise.break_r
        turn = torch.where(r == 2, int(Action.LEFT), int(Action.RIGHT)).to(I32)
        esc_req = torch.where((r <= 1) & fwd_hw, int(Action.FORWARD), turn)
        req = torch.where(esc, esc_req, req)
        agent_break = torch.where(esc, agent_break - 1, agent_break)

    # ---------------- Phase 2: move-conflict resolution ---------------------
    fwd_x = (x + _lookup(_DIR_DX, state.agent_dir)).clamp(0, W - 1)
    fwd_y = (y + _lookup(_DIR_DY, state.agent_dir)).clamp(0, H - 1)
    is_fwd = req == Action.FORWARD
    req_x = torch.where(is_fwd, fwd_x, x)
    req_y = torch.where(is_fwd, fwd_y, y)
    mover = is_fwd & ((req_x != x) | (req_y != y))

    picker_at_req = picker_at(req_x, req_y)
    agv_at_req = agv_at(req_x, req_y)
    occ_same = torch.where(is_picker, picker_at_req, agv_at_req)
    occ_other = torch.where(is_picker, agv_at_req, picker_at_req)
    dest_hw = grid_at(params.highway, req_y, req_x)
    block_same = occ_same > 0
    block_other = (occ_other > 0) & dest_hw
    occupied_block = mover & (block_same | block_other)

    # Same-destination contention: on highway cells both layers contend; on
    # rack cells only same-layer movers contend (cross-type may overlap).
    contender = mover & ~occupied_block
    elig = contender & (fixing == 0)
    same_dest = (req_x[:, :, None] == req_x[:, None, :]) & (
        req_y[:, :, None] == req_y[:, None, :]
    )
    layer_compat = (is_picker[:, None] == is_picker[None, :])[None] | dest_hw[:, :, None]
    higher = aidx[None, :] > aidx[:, None]
    yields = elig & (same_dest & layer_compat & higher & elig[:, None, :]).any(dim=2)
    moved = contender & ~yields

    # Clash detection against the blocking occupant (warehouse.py:461-473).
    occ_id = torch.where(block_same, occ_same, torch.where(block_other, occ_other, 0))
    occ_i = (occ_id - 1).clamp(min=0)
    has_occ = occupied_block & (occ_id > 0)
    occ_req, occ_is_mover, occ_moved, occ_dest_x, occ_dest_y, occ_fixing = take_many(
        occ_i, req, mover, moved, req_x, req_y, fixing
    )
    occ_rotating = (occ_req == Action.LEFT) | (occ_req == Action.RIGHT)
    occ_heads_back = ((occ_dest_x == x) & (occ_dest_y == y)) | (
        (occ_dest_x == req_x) & (occ_dest_y == req_y)
    )
    trigger = (
        has_occ
        & ~occ_rotating
        & ~occ_moved
        & (occ_fixing == 0)
        & (~occ_is_mover | occ_heads_back)
    )
    clashes = trigger.sum(1, dtype=I32)

    fixing = torch.where(yields, FIXING_CLASH_TIME, fixing)
    fixing = torch.where(trigger & dyn_ok, FIXING_CLASH_TIME, torch.where(trigger, 0, fixing))
    replan = replan | (trigger & dyn_ok)
    req = torch.where(mover & ~moved, int(Action.NOOP), req)

    # ---------------- Phase 3: stuck resolution (warehouse.py:486-519) ------
    at_goal = grid_at(params.is_goal, y, x)
    consider = (
        busy
        & (req != Action.LEFT)
        & (req != Action.RIGHT)
        & ((req != Action.TOGGLE_LOAD) | at_goal)
    )
    same_pos = (x == stuck_xy[..., 0]) & (y == stuck_xy[..., 1])
    stuck_count = torch.where(
        consider, torch.where(same_pos, stuck_count + 1, 0), stuck_count
    )
    stuck_xy = torch.where((consider & ~same_pos)[..., None], xy, stuck_xy)

    upper = STUCK_THRESHOLD + params.column_height + 2
    c1 = consider & (stuck_count > STUCK_THRESHOLD) & (stuck_count < upper)
    c2 = consider & (stuck_count > upper)

    req = torch.where(c1 | c2, int(Action.NOOP), req)
    # c1, path nonempty: replan around agents if possible (warehouse.py:502-509)
    c1_replan = c1 & ~arrived & dyn_ok
    replan = replan | c1_replan
    reset1 = c1_replan & (dyn_dist_at > 1)
    stuck_count = torch.where(reset1, 0, stuck_count)
    stuck_xy = torch.where(reset1[..., None], xy, stuck_xy)
    # c1, path empty (toggling at goal, blocked): abandon (warehouse.py:510-513)
    c1_abandon = c1 & arrived
    busy = busy & ~c1_abandon
    stuck_count = torch.where(c1_abandon, 0, stuck_count)
    # c2: hard abandon (warehouse.py:514-519)
    busy = busy & ~c2
    stuck_count = torch.where(c2, 0, stuck_count)
    stuck_xy = torch.where(c2[..., None], xy, stuck_xy)
    stucks = c1_abandon.sum(1, dtype=I32) + c2.sum(1, dtype=I32)
    if params.deadlock_break:
        # Arm the escape on hard abandon and on "replanned but no detour".
        no_detour = c1_replan & (dyn_dist_at >= INF32)
        agent_break = torch.where(c2 | no_detour, params.deadlock_break, agent_break)

    # ---------------- Phase 4: execute micro actions (warehouse.py:521-590) -
    rewards = torch.full((B, A), -STEP_PENALTY, dtype=torch.float32, device=dev)

    do_fwd = req == Action.FORWARD
    new_x = torch.where(do_fwd, req_x, x)
    new_y = torch.where(do_fwd, req_y, y)
    new_xy = torch.stack([new_x, new_y], dim=-1)

    wheel = _lookup(_DIR_TO_WHEEL, state.agent_dir)
    new_wheel = torch.where(
        req == Action.RIGHT,
        (wheel + 1) % 4,
        torch.where(req == Action.LEFT, (wheel - 1) % 4, wheel),
    )
    new_dir = _lookup(_WHEEL_TO_DIR, new_wheel)

    toggling = req == Action.TOGGLE_LOAD
    carrying = state.agent_carrying
    picker_here = picker_at(x, y) > 0
    here_shelf = shelf_at(x, y)
    handler_ok = (is_agv & picker_here) | is_agent
    # Load (warehouse.py:530-552)
    wants_load = toggling & (carrying == 0)
    can_load = wants_load & (here_shelf > 0) & handler_ok
    load_fail = wants_load & (here_shelf == 0)
    carrying = torch.where(can_load, here_shelf, carrying)
    busy = busy & ~(can_load | load_fail)

    # Unload (warehouse.py:554-577)
    wants_unload = toggling & (state.agent_carrying > 0)
    unload_blocked = wants_unload & (at_goal | (here_shelf > 0))
    busy = busy & ~unload_blocked
    can_unload = (
        wants_unload & ~unload_blocked & ~grid_at(params.highway, y, x) & handler_ok
    )
    placed_shelf = torch.where(can_unload, state.agent_carrying, 0)
    carrying = torch.where(can_unload, 0, carrying)
    busy = busy & ~can_unload
    has_delivered = state.agent_has_delivered & ~can_unload

    # Handoff rewards (load or unload): the picker at the cell gets credit
    # (or the AGENT itself).
    handoff = can_load | can_unload
    if params.reward_type == RewardType.GLOBAL:
        rewards = rewards + handoff.sum(1, keepdim=True).to(torch.float32) * HANDOFF_REWARD_GLOBAL
    elif params.reward_type == RewardType.INDIVIDUAL:
        self_credit = handoff & is_agent
        picker_credit_id = torch.where(handoff & is_agv, picker_at(x, y), 0)
        rewards = rewards + self_credit.to(torch.float32) * HANDOFF_REWARD_INDIVIDUAL
        credited = (
            (picker_credit_id[:, None, :] == (aidx + 1)[None, :, None])
            .to(torch.float32)
            .sum(2)
        )
        rewards = rewards + credited * HANDOFF_REWARD_INDIVIDUAL

    # Shelf positions: a shelf follows the agent that placed it this step
    # (warehouse.py:564) or carries it (:524-525). Row S is a sink for
    # agents that hold no shelf.
    moved_xy = torch.cat(
        [state.shelf_xy, torch.zeros(B, 1, 2, dtype=I32, device=dev)], dim=1
    )
    carried_slot = torch.where(carrying > 0, carrying - 1, S).long()
    moved_xy = moved_xy.scatter(1, carried_slot[..., None].expand(B, A, 2), new_xy)
    placed_slot = torch.where(placed_shelf > 0, placed_shelf - 1, S).long()
    moved_xy = moved_xy.scatter(1, placed_slot[..., None].expand(B, A, 2), xy)
    shelf_xy = moved_xy[:, :S].contiguous()

    # ---------------- Phase 5: shelf deliveries (warehouse.py:592-619) ------
    # Uses positions from the START of this step, like the reference.
    goal_cells = (params.goals_yx[:, 0] * W + params.goals_yx[:, 1]).long()
    goal_shelf = carried_grid[:, goal_cells]  # (B, G) carried shelf id at each goal
    goal_agent = agv_grid[:, goal_cells]  # (B, G) AGV id at each goal
    carried_now = id_flags(carrying, S)
    in_q = id_flags(state.request_queue, S)
    queue = state.request_queue
    n_del = torch.zeros(B, dtype=I32, device=dev)
    for g in range(params.num_goals):
        shelf_id = goal_shelf[:, g]
        agent_id = goal_agent[:, g]
        s_idx = (shelf_id - 1).clamp(min=0).long()[:, None]
        valid = (shelf_id > 0) & in_q.gather(1, s_idx)[:, 0]
        # Replacement: uniform over shelves neither requested nor carried
        # (warehouse.py:599-603), by gumbel-max.
        cand = ~in_q & ~carried_now
        gumbel = noise.delivery_gumbel[:, g]
        new_shelf = torch.where(cand, gumbel, float("-inf")).argmax(dim=1).to(I32) + 1
        slot = (queue == shelf_id[:, None]).to(torch.uint8).argmax(dim=1)
        vq = valid[:, None]
        queue = torch.where(vq, queue.scatter(1, slot[:, None], new_shelf[:, None]), queue)
        in_q = torch.where(
            vq,
            in_q.scatter(1, s_idx, False).scatter(1, (new_shelf - 1).long()[:, None], True),
            in_q,
        )
        a_idx = (agent_id - 1).clamp(min=0).long()[:, None]
        credit = valid & (agent_id > 0)
        first = credit & ~has_delivered.gather(1, a_idx)[:, 0]
        has_delivered = torch.where(credit[:, None], has_delivered.scatter(1, a_idx, True), has_delivered)
        gain = torch.where(first, DELIVERY_REWARD, 0.0).to(torch.float32)
        if params.reward_type == RewardType.GLOBAL:
            rewards = rewards + gain[:, None]
        elif params.reward_type == RewardType.INDIVIDUAL:
            rewards = rewards.scatter_add(1, a_idx, gain[:, None])
        n_del = n_del + valid.to(I32)
    request_queue = queue

    cur_inactive = torch.where(n_del > 0, 0, state.cur_inactive + 1)
    cur_steps = state.cur_steps + 1

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if params.max_inactivity_steps:
        done = done | (cur_inactive >= params.max_inactivity_steps)
    if params.max_steps:
        done = done | (cur_steps >= params.max_steps)

    if params.replan_rejoin:
        # Exit replan mode where the dynamic field has rejoined the static
        # one at the agent's own cell (same next hop, same distance).
        rejoined = use_dyn & dyn_ok & (dyn_nd_at == s_nd) & (dyn_dist_at == s_dist)
        replan = replan & ~rejoined
    replan = replan & busy

    new_state = EnvState(
        agent_xy=new_xy,
        agent_dir=new_dir,
        agent_busy=busy,
        agent_target=target,
        agent_carrying=carrying,
        agent_fixing_clash=fixing,
        agent_replan=replan,
        agent_has_delivered=has_delivered,
        agent_req_action=req,
        stuck_count=stuck_count,
        stuck_xy=stuck_xy,
        agent_break=agent_break,
        shelf_xy=shelf_xy,
        request_queue=request_queue,
        cur_steps=cur_steps,
        cur_inactive=cur_inactive,
    )

    idle = (req == Action.NOOP) | (req == Action.TOGGLE_LOAD)
    info = {
        "vehicles_busy": busy,
        "shelf_deliveries": n_del,
        "clashes": clashes,
        "stucks": stucks,
        "agvs_distance_travelled": agvs_distance,
        "pickers_distance_travelled": pickers_distance,
        "agvs_idle_time": (idle & ~is_picker).sum(1, dtype=I32),
        "pickers_idle_time": (idle & is_picker).sum(1, dtype=I32),
        # Needed rows beyond the batched-BFS compaction budget
        # (replan_row_frac); monitored, never silently truncated.
        "replan_overflow": replan_overflow,
    }
    return new_state, rewards, done, info
