"""Observations and the state queries the dispatcher needs.

Counterpart of `swarm_ode_tpu/env/observations.py`, batched over B envs:
the state queries (reference warehouse.py:332-356), the action masks
(warehouse.py:727-752) and `observe`, the agents' flat observation vectors
(reference spaces/MultiAgentGlobalObservationSpace.py:31-81 and
MultiAgentPartialObservationSpace.py:10-114), batched to (B, A, max_len).
The JAX package assembles each agent's ragged vector with a trace-time loop
over agents; here that layout is a static gather pattern, built once per
configuration (`_obs_index`), and one gather per step fills every row.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from swarm_ode_tpu_torch.definitions import Action, AgentType
from swarm_ode_tpu_torch.env.queries import cell_max, id_flags, occupant_grid
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState
from swarm_ode_tpu_torch.ops.take import take_ids


def _carried_flags(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, S) bool: shelf s+1 is carried by some agent."""
    return id_flags(state.agent_carrying, params.num_shelves)


def _shelf_id_at(params: EnvParams, state: EnvState, cells_yx: torch.Tensor) -> torch.Tensor:
    """(B, Q) non-carried shelf id at each (y, x) query cell (the reference's
    SHELVES layer)."""
    H, W = params.grid_h, params.grid_w
    grid = occupant_grid(state.shelf_xy, ~_carried_flags(params, state), H, W)
    return grid[:, (cells_yx[:, 0] * W + cells_yx[:, 1]).long()]


def empty_shelf_info(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, L) float: rack cell is free to receive a shelf — no shelf present
    and no AGV about to unload there (reference warehouse.py:344-356)."""
    H, W = params.grid_h, params.grid_w
    cells = (params.rack_cells[:, 0] * W + params.rack_cells[:, 1]).long()
    sid = _shelf_id_at(params, state, params.rack_cells)
    # Carried shelf at the rack cell and the occupying loader's last action.
    cid = cell_max(state.agent_xy, state.agent_carrying, H, W)[:, cells]
    is_loader = params.agent_type != AgentType.PICKER
    aid = occupant_grid(state.agent_xy, is_loader, H, W)[:, cells]
    areq = torch.where(
        aid > 0,
        take_ids(state.agent_req_action, (aid - 1).clamp(min=0)),
        int(Action.NOOP),
    )
    pending_unload = (cid > 0) & ((areq == Action.NOOP) | (areq == Action.TOGGLE_LOAD))
    return ((sid == 0) & ~pending_unload).to(torch.float32)


def shelf_request_info(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, L) float32: the rack cell holds a requested shelf. Action-id
    order (reference warehouse.py:335-342)."""
    sid = _shelf_id_at(params, state, params.rack_cells)
    return ((sid > 0) & take_ids(_in_queue(params, state), sid)).to(torch.float32)


def carrying_shelf_info(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, num_agvs) bool (reference warehouse.py:332-333)."""
    return state.agent_carrying[:, : params.num_agvs] > 0


def _rack_flags(target: torch.Tensor, G: int, L: int) -> torch.Tensor:
    """(B, L) bool: some agent's target is rack cell l. The JAX masks write
    through `target - G - 1` with L as the drop index for non-rack targets
    (`.at[...].set(..., mode="drop")`); here the drop index is a last column
    of an (L + 1)-wide buffer, cut off after the scatter."""
    slot = torch.where(target > G, target - G - 1, L).long()
    flags = torch.zeros(target.shape[0], L + 1, dtype=torch.bool, device=target.device)
    return flags.scatter(1, slot, True)[:, :L]


def compute_valid_action_masks(
    params: EnvParams,
    state: EnvState,
    pickers_to_agvs: bool = True,
    block_conflicting_actions: bool = True,
) -> torch.Tensor:
    """(B, A, action_size) float32 mask (reference warehouse.py:727-752)."""
    Na, G, L = params.num_agvs, params.num_goals, params.num_racks
    requested = shelf_request_info(params, state)
    empty = empty_shelf_info(params, state)
    carrying = carrying_shelf_info(params, state).to(torch.float32)  # (B, Na)
    agv_targeted = _rack_flags(state.agent_target[:, :Na], G, L)
    pick_targeted = _rack_flags(state.agent_target[:, Na:], G, L)

    valid_agvs = torch.where(carrying[..., None] > 0, empty[:, None, :], requested[:, None, :])
    valid_pickers = agv_targeted.to(torch.float32) if pickers_to_agvs else requested
    if block_conflicting_actions:
        valid_agvs = torch.where(agv_targeted[:, None, :], 0.0, valid_agvs)
        valid_pickers = torch.where(pick_targeted, 0.0, valid_pickers)

    B = state.batch
    masks = torch.ones(B, params.num_agents, params.num_actions, dtype=torch.float32,
                       device=carrying.device)
    masks[:, :Na, 1 + G:] = valid_agvs
    masks[:, :Na, 1:1 + G] = carrying[..., None]
    masks[:, Na:, 1 + G:] = valid_pickers[:, None, :]
    masks[:, Na:, 1:1 + G] = 0.0
    return masks


def _lengths(num_agvs: int, num_pickers: int, num_racks: int, observation_type: str):
    A, P, L = num_agvs, num_pickers, num_racks
    if observation_type == "global":
        n = 7 * A + 4 * P + 2 * L
        return n, n
    return 3 + 4 * A + 4 * P + 2 * L, 7 * A + 4 * P


def obs_lengths(params: EnvParams) -> Tuple[int, int]:
    """(agv_obs_len, picker_obs_len) for the configured observation type.

    Global: both 7*A + 4*P + 2*L (Global:31-43).
    Partial: AGV 3 + 4*(A+P) + 2*L; Picker 7*A + 4*P (Partial:35-59).
    """
    return _lengths(params.num_agvs, params.num_pickers, params.num_racks,
                    params.observation_type)


def _coords(params: EnvParams, yx_pairs: torch.Tensor) -> torch.Tensor:
    """process_coordinates (reference spaces/MultiAgentBaseObservationSpace.py:31-35).
    yx_pairs: (..., 2) float32 (y, x)."""
    if params.normalised_coordinates:
        scale = torch.tensor(
            [1.0 / (params.grid_h - 1), 1.0 / (params.grid_w - 1)],
            dtype=torch.float32, device=yx_pairs.device,
        )
        return yx_pairs * scale
    return yx_pairs


def _in_queue(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, S+1) bool: shelf id k is requested (index 0, no shelf, is False)."""
    flags = id_flags(state.request_queue, params.num_shelves)
    return torch.cat([torch.zeros_like(flags[:, :1]), flags], dim=1)


def _agent_infos(params: EnvParams, state: EnvState):
    """Per-agent info pieces shared by both obs spaces.

    Returns full7 (B, A, 7) [carrying, carrying_requested, toggling, y, x,
    ty, tx] (meaningful for AGV-type agents) and pos4 (B, A, 4) [y, x, ty,
    tx], float32."""
    carrying = state.agent_carrying > 0
    carrying_req = carrying & take_ids(_in_queue(params, state), state.agent_carrying)
    toggling = state.agent_req_action == Action.TOGGLE_LOAD
    own_yx = state.agent_xy.flip(-1).to(torch.float32)
    has_tgt = (state.agent_target > 0)[..., None]
    tgt_yx = params.action_cells[(state.agent_target - 1).clamp(min=0).long()].to(torch.float32)
    tgt_c = torch.where(has_tgt, _coords(params, tgt_yx), 0.0)
    pos4 = torch.cat([_coords(params, own_yx), tgt_c], dim=-1)
    flags = torch.stack([carrying, carrying_req, toggling], dim=-1).to(torch.float32)
    return torch.cat([flags, pos4], dim=-1), pos4


def _shelves_obs(params: EnvParams, state: EnvState) -> torch.Tensor:
    """(B, 2L) [has_shelf, is_requested] per rack cell in rack-group order
    (reference Global:65-72, Partial:87-95)."""
    cells = params.rack_cells[params.obs_rack_perm.long()]
    sid = _shelf_id_at(params, state, cells)
    has = sid > 0
    req = has & take_ids(_in_queue(params, state), sid)
    return torch.stack([has, req], dim=-1).to(torch.float32).flatten(1)


@functools.lru_cache(maxsize=None)
def _obs_index(num_agvs: int, num_pickers: int, num_racks: int, observation_type: str,
               device: torch.device) -> torch.Tensor:
    """(A, max_len) int64 gather pattern of `observe`.

    Indices point into each env's source vector [full7 of every agent (7A),
    pos4 of every agent (4A), shelves (2L), one zero]; the zero pads rows.
    The pieces and their order follow the JAX package's loop at
    observations.py:218-252 (types are static per index: AGVs first, AGENT
    type when there are no pickers)."""
    A, L = num_agvs + num_pickers, num_racks
    max_len = max(_lengths(num_agvs, num_pickers, L, observation_type))
    shelves = list(range(11 * A, 11 * A + 2 * L))
    zero = 11 * A + 2 * L

    def full7(j):
        return list(range(7 * j, 7 * j + 7))

    def pos4(j):
        return list(range(7 * A + 4 * j, 7 * A + 4 * j + 4))

    def info(j):  # an AGV's 7-tuple, a picker's (or AGENT's) 4-tuple
        return full7(j) if j < num_agvs and num_pickers > 0 else pos4(j)

    rows = []
    for i in range(A):
        others = [j for j in range(A) if j != i]
        if observation_type == "global":
            row = info(i) + sum((info(j) for j in others), []) + shelves
        elif i < num_agvs and num_pickers > 0:
            # AGV: own full info, others' positions, shelf state (Partial:100-105).
            row = full7(i) + sum((pos4(j) for j in others), []) + shelves
        else:
            # Picker (or AGENT): own position, everyone else's info, no
            # shelf state (Partial:106-110).
            row = pos4(i) + sum((info(j) for j in others), [])
        rows.append(row + [zero] * (max_len - len(row)))
    return torch.tensor(np.array(rows, dtype=np.int64), device=device)


def observe(params: EnvParams, state: EnvState) -> torch.Tensor:
    """All agents' observations, zero-padded to (B, A, max_obs_len) float32.

    Row i reproduces the reference's flat vector for agent i exactly
    (trailing zero padding included, as collect_data.py:69-127 logs it)."""
    B, A = state.agent_dir.shape
    full7, pos4 = _agent_infos(params, state)
    src = torch.cat([
        full7.reshape(B, 7 * A),
        pos4.reshape(B, 4 * A),
        _shelves_obs(params, state),
        torch.zeros(B, 1, dtype=torch.float32, device=full7.device),
    ], dim=1)
    idx = _obs_index(params.num_agvs, params.num_pickers, params.num_racks,
                     params.observation_type, full7.device)
    return src[:, idx.reshape(-1)].view(B, A, idx.shape[1])
