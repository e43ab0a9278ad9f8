"""State queries the dispatcher needs.

Counterpart of the part of `swarm_ode_tpu/env/observations.py` that the
heuristic rollout reaches: `empty_shelf_info` and its helpers.
`observe` and the action masks belong to the env API and are not ported
yet.
"""
from __future__ import annotations

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
