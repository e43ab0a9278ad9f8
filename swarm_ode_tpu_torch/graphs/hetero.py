"""Heterogeneous env-state graph as dense masked adjacency, over B envs.

Counterpart of `swarm_ode_tpu/graphs/hetero.py` (HeteroGraph :30,
split_observation :45, build_hetero_graph :64, masks_from_feats :171,
hetero_graph_from_obs :242), with a leading batch dimension B on every
tensor. Semantics follow the reference's observation-driven
`MultiAgentGraphConverter` (run_gnode.py:1041-1326): node features are
slices of the partial observation, and the six relations are boolean
(src, dst) adjacency matrices over fixed node sets, so message passing is a
batched masked matrix product (ops/sage.masked_mean_aggregate).

Two rules keep the results bit for bit JAX's:
  * `cell_to_rack[y, x]` gathers with indices cast from float features; JAX
    wraps a negative index once and clamps the rest into range, and so does
    `_cell_to_rack` (CUDA would read out of bounds);
  * JAX's `mode="drop"` scatters write into an (L + 1)-wide buffer whose last
    column takes the dropped writes and is cut off after.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from swarm_ode_tpu_torch.env.state import EnvParams

AGV_FEATS = 7  # [carrying, carrying_requested, toggling, y, x, ty, tx]
PICKER_FEATS = 4  # [y, x, ty, tx]
LOC_FEATS = 2  # [has_shelf, is_requested]

I32 = torch.int32


@dataclasses.dataclass
class HeteroGraph:
    """Node features and six boolean relations of B graphs (reference edge
    types at run_gnode.py:89-95), adjacency[b, src, dst]."""

    agv_x: torch.Tensor  # (B, A, 7) float32
    picker_x: torch.Tensor  # (B, P, 4) float32
    loc_x: torch.Tensor  # (B, L, 2) float32
    agv2loc: torch.Tensor  # (B, A, L) bool 'targets'
    loc2agv: torch.Tensor  # (B, L, A) bool 'is targeted by'
    agv2agv: torch.Tensor  # (B, A, A) bool 'communicates'
    pick2loc: torch.Tensor  # (B, P, L) bool 'manages'
    agv2pick: torch.Tensor  # (B, A, P) bool 'cooperates with'
    pick2agv: torch.Tensor  # (B, P, A) bool 'helps'


def split_observation(params: EnvParams, obs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(agv_feats (B, A, 7), picker_feats (B, P, 4), loc_feats (B, L, 2)) from
    partial observations (B, A_total, obs_len) (reference
    run_gnode.py:1085-1101). Location features are the shelf block of agent
    0's row, in obs (rack-group) order."""
    A, P, L = params.num_agvs, params.num_pickers, params.num_racks
    agv_feats = obs[:, :A, :AGV_FEATS]
    picker_feats = obs[:, A:, :PICKER_FEATS]
    # Agent 0's shelf block starts after its own 7 features plus 4 per
    # other agent (run_gnode.py:1098).
    start = AGV_FEATS + PICKER_FEATS * (A + P - 1)
    loc_feats = obs[:, 0, start:start + 2 * L].reshape(obs.shape[0], L, 2)
    return agv_feats, picker_feats, loc_feats


def _cell_to_rack(params: EnvParams, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`params.cell_to_rack[y, x]` with JAX's index rule: a negative index
    counts from the end once, then every index is clamped into range."""
    H, W = params.grid_h, params.grid_w
    y = torch.where(y < 0, y + H, y).clamp(0, H - 1)
    x = torch.where(x < 0, x + W, x).clamp(0, W - 1)
    return params.cell_to_rack.reshape(-1)[(y * W + x).long()]


def _has_target(ty: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """Node features encode 'no target' as (ty, tx) = (0, 0)."""
    return ~((ty == 0) & (tx == 0))


def build_hetero_graph(
    params: EnvParams,
    agv_feats: torch.Tensor,  # (B, A, 7)
    picker_feats: torch.Tensor,  # (B, P, 4)
    loc_feats: torch.Tensor,  # (B, L, 2) in obs (rack-group) order
    max_comm_distance: float = 5.0,
) -> HeteroGraph:
    """The six relations (reference run_gnode.py:1159-1326)."""
    A = params.num_agvs
    rl = params.rack_locations_xyg  # (L, 3) (x, y, group), obs order

    def section_of(x, y):
        """Rack-section id at (x, y), -1 off rack cells."""
        ridx = _cell_to_rack(params, y, x)
        grp = params.rack_group[ridx.clamp(min=0).long()]
        return torch.where(ridx >= 0, grp, -1)

    agv_pos_yx = agv_feats[..., 3:5].to(I32)  # (B, A, 2) (y, x)
    agv_tgt_yx = agv_feats[..., 5:7].to(I32)
    agv_has_tgt = _has_target(agv_tgt_yx[..., 0], agv_tgt_yx[..., 1])
    pick_pos_yx = picker_feats[..., 0:2].to(I32)
    pick_tgt_yx = picker_feats[..., 2:4].to(I32)
    pick_has_tgt = _has_target(pick_tgt_yx[..., 0], pick_tgt_yx[..., 1])

    requested_loc = (loc_feats[..., 0] > 0) & (loc_feats[..., 1] > 0)  # (B, L)

    loc_sec = rl[:, 2]  # (L,)
    agv_tgt_sec = section_of(agv_tgt_yx[..., 1], agv_tgt_yx[..., 0])
    agv_tgt_sec = torch.where(agv_has_tgt, agv_tgt_sec, -1)
    pick_tgt_sec = section_of(pick_tgt_yx[..., 1], pick_tgt_yx[..., 0])
    pick_tgt_sec = torch.where(pick_has_tgt, pick_tgt_sec, -1)
    pick_cur_sec = section_of(pick_pos_yx[..., 1], pick_pos_yx[..., 0])

    # AGV -> location ('targets'; run_gnode.py:1196-1220): with a target,
    # the one location matching it; without, every requested location.
    tgt_match = (rl[:, 0] == agv_tgt_yx[..., 1:2]) & (rl[:, 1] == agv_tgt_yx[..., 0:1])
    agv2loc = torch.where(agv_has_tgt[..., None], tgt_match, requested_loc[:, None, :])

    # AGV <-> AGV ('communicates'; run_gnode.py:1222-1247).
    d_agv = (agv_pos_yx[:, :, None, :] - agv_pos_yx[:, None, :, :]).abs().sum(-1)
    agv_sec_ok = agv_tgt_sec >= 0
    same_sec = ((agv_tgt_sec[:, :, None] == agv_tgt_sec[:, None, :])
                & agv_sec_ok[:, :, None] & agv_sec_ok[:, None, :])
    eye = torch.eye(A, dtype=torch.bool, device=agv_feats.device)
    agv2agv = ((d_agv <= max_comm_distance) | same_sec) & ~eye

    # Picker -> location ('manages'; run_gnode.py:1249-1273).
    p_tgt_match = (rl[:, 0] == pick_tgt_yx[..., 1:2]) & (rl[:, 1] == pick_tgt_yx[..., 0:1])
    zone_req = ((pick_cur_sec[..., None] == loc_sec)
                & (pick_cur_sec >= 0)[..., None] & requested_loc[:, None, :])
    pick2loc = torch.where(pick_has_tgt[..., None], p_tgt_match, zone_req)

    # AGV <-> Picker ('cooperates with' / 'helps'; run_gnode.py:1275-1321).
    d_ap = (agv_pos_yx[:, :, None, :] - pick_pos_yx[:, None, :, :]).abs().sum(-1)
    close = d_ap <= max_comm_distance
    both_tgt = agv_has_tgt[:, :, None] & pick_has_tgt[:, None, :]
    same_tgt = both_tgt & (
        (agv_tgt_yx[:, :, None, 0] == pick_tgt_yx[:, None, :, 0])
        & (agv_tgt_yx[:, :, None, 1] == pick_tgt_yx[:, None, :, 1])
    )
    same_tgt_sec = (both_tgt & ~same_tgt
                    & (agv_tgt_sec[:, :, None] == pick_tgt_sec[:, None, :])
                    & agv_sec_ok[:, :, None] & (pick_tgt_sec >= 0)[:, None, :])
    tgt_in_pick_sec = (~both_tgt & agv_has_tgt[:, :, None]
                       & (agv_tgt_sec[:, :, None] == pick_cur_sec[:, None, :])
                       & agv_sec_ok[:, :, None] & (pick_cur_sec >= 0)[:, None, :])
    agv2pick = close | same_tgt | same_tgt_sec | tgt_in_pick_sec

    return HeteroGraph(
        agv_x=agv_feats.to(torch.float32),
        picker_x=picker_feats.to(torch.float32),
        loc_x=loc_feats.to(torch.float32),
        agv2loc=agv2loc,
        loc2agv=agv2loc.transpose(1, 2),
        agv2agv=agv2agv,
        pick2loc=pick2loc,
        agv2pick=agv2pick,
        pick2agv=agv2pick.transpose(1, 2),
    )


def masks_from_feats(
    params: EnvParams,
    agv_feats: torch.Tensor,  # (B, A, 7)
    picker_feats: torch.Tensor,  # (B, P, 4)
    loc_feats: torch.Tensor,  # (B, L, 2) obs (rack-group) order
) -> torch.Tensor:
    """(B, A_total, num_actions) float32 valid-action masks reconstructed
    from node features alone (compute_valid_action_masks, reference
    warehouse.py:727-752), for the TD targets of replayed transitions. A
    carrying AGV on a rack cell that is its target (or toggling) stands for
    the pending unload the features do not carry; see the JAX function's
    docstring for the rare gap this leaves."""
    A, L, G = params.num_agvs, params.num_racks, params.num_goals
    B = agv_feats.shape[0]
    dev = agv_feats.device
    loc_action = loc_feats[:, params.obs_rack_perm_inv.long()]  # (B, L, 2) action order
    has_shelf = loc_action[..., 0] > 0
    requested = (has_shelf & (loc_action[..., 1] > 0)).to(torch.float32)
    carrying = agv_feats[..., 0] > 0
    ay, ax = agv_feats[..., 3].to(I32), agv_feats[..., 4].to(I32)
    aty, atx = agv_feats[..., 5].to(I32), agv_feats[..., 6].to(I32)
    cur_rack = _cell_to_rack(params, ay, ax)  # -1 off racks
    at_target = (ay == aty) & (ax == atx) & _has_target(aty, atx)
    toggling = agv_feats[..., 2] > 0
    pending_agv = carrying & (cur_rack >= 0) & (at_target | toggling)

    def flags(slot):
        """(B, L) bool set at each slot < L; slot L is the dropped write."""
        buf = torch.zeros(B, L + 1, dtype=torch.bool, device=dev)
        return buf.scatter(1, slot.long(), True)[:, :L]

    pending = flags(torch.where(pending_agv, cur_rack, L))
    empty = (~has_shelf & ~pending).to(torch.float32)

    def rack_target(tyx):
        ty, tx = tyx[..., 0].to(I32), tyx[..., 1].to(I32)
        ridx = _cell_to_rack(params, ty, tx)
        return torch.where(_has_target(ty, tx) & (ridx >= 0), ridx, L)

    agv_targeted = flags(rack_target(agv_feats[..., 5:7]))
    pick_targeted = flags(rack_target(picker_feats[..., 2:4]))

    valid_agvs = torch.where(carrying[..., None], empty[:, None, :], requested[:, None, :])
    valid_agvs = torch.where(agv_targeted[:, None, :], 0.0, valid_agvs)
    # JAX sets 1 at the AGVs' targets, then 0 at the pickers'.
    valid_pickers = torch.where(pick_targeted, 0.0, agv_targeted.to(torch.float32))

    masks = torch.ones(B, params.num_agents, params.num_actions, dtype=torch.float32, device=dev)
    masks[:, :A, 1 + G:] = valid_agvs
    masks[:, :A, 1:1 + G] = carrying.to(torch.float32)[..., None]
    masks[:, A:, 1 + G:] = valid_pickers[:, None, :]
    masks[:, A:, 1:1 + G] = 0.0
    return masks


def hetero_graph_from_obs(params: EnvParams, obs: torch.Tensor,
                          max_comm_distance: float = 5.0) -> HeteroGraph:
    """Observations (B, A_total, obs_len) -> HeteroGraph (the reference
    converter's entry point, run_gnode.py:1073)."""
    agv_f, pick_f, loc_f = split_observation(params, obs)
    return build_hetero_graph(params, agv_f, pick_f, loc_f, max_comm_distance)
