"""Conflict-masked sequential action selection (greedy claim auction), over
B envs.

Counterpart of `swarm_ode_tpu/rl/coordination.py` (_selection_order :41,
coordinated_argmax :48, coordinated_epsilon_greedy :97, coordinated_sample
:121, sequential_log_prob :150, busy_from_feats :196); see the JAX module
for the auction's semantics and guarantees. Agents choose in descending
order of their best masked utility; an active agent that takes a rack
action strikes that rack from the menus of later agents of its own type;
busy agents select but never claim.

The JAX package runs the claim order as a `lax.scan`; here it is a loop
over the A positions of the order, each env gathering its own agent at
that position. Random draws are passed in (uniforms and Gumbels), so the
tests can give JAX's own.
"""
from __future__ import annotations

from typing import Optional

import torch

BIG_NEG = -1e9


def _selection_order(scores: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(B, A) claim order: best score first, busy agents last (a stable
    sort, as jnp.argsort is). Shared by selection and density, which must
    agree for sequential_log_prob to be the density of coordinated_sample."""
    return torch.argsort(-(scores - torch.where(active, 0.0, 1e12)), dim=-1, stable=True)


def _claim_pass(rows: torch.Tensor, order: torch.Tensor, active: torch.Tensor, num_agvs: int,
                rack_start: int, actions: Optional[torch.Tensor] = None):
    """The auction's sequential pass: at each position j of `order`, agent i
    = order[:, j] sees `rows[:, i]` with its type's claimed racks struck
    (BIG_NEG), picks its argmax (or `actions[:, i]` when given), and
    claims it if active and a rack. Yields (i, the struck row, the action)
    per position."""
    B, A, n = rows.shape
    bidx = torch.arange(B, device=rows.device)
    col = torch.arange(n, device=rows.device)
    claimed_agv = torch.zeros(B, n, dtype=torch.bool, device=rows.device)
    claimed_pick = torch.zeros_like(claimed_agv)
    for j in range(A):
        i = order[:, j]
        is_picker = (i >= num_agvs)[:, None]
        claimed = torch.where(is_picker, claimed_pick, claimed_agv)
        row = torch.where(claimed, BIG_NEG, rows[bidx, i])
        a = row.argmax(dim=-1) if actions is None else actions[bidx, i].long()
        take = active[bidx, i] & (a >= rack_start)
        claimed_new = claimed | ((col == a[:, None]) & take[:, None])
        claimed_agv = torch.where(is_picker, claimed_agv, claimed_new)
        claimed_pick = torch.where(is_picker, claimed_new, claimed_pick)
        yield i, row, a


def _ones_active(q):
    return torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)


def coordinated_argmax(q: torch.Tensor, masks: torch.Tensor, num_agvs: int, rack_start: int,
                       active: Optional[torch.Tensor] = None,
                       order_scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential conflict-masked argmax: q and masks (B, A, n), active
    (B, A) bool (False = busy), order_scores (B, A) overriding the claim
    order (default: each agent's best masked utility). Returns (B, A)
    int32 actions."""
    masked = torch.where(masks > 0, q, BIG_NEG)
    if active is None:
        active = _ones_active(q)
    if order_scores is None:
        order_scores = masked.max(dim=-1).values
    order = _selection_order(order_scores, active)
    acts = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    bidx = torch.arange(q.shape[0], device=q.device)
    for i, _, a in _claim_pass(masked, order, active, num_agvs, rack_start):
        acts[bidx, i] = a.to(torch.int32)
    return acts


def coordinated_epsilon_greedy(q: torch.Tensor, masks: torch.Tensor, num_agvs: int,
                               rack_start: int, epsilon, explore_u: torch.Tensor,
                               bids_u: torch.Tensor, active: Optional[torch.Tensor] = None,
                               training: bool = True) -> torch.Tensor:
    """Epsilon-greedy under the claim auction: agents whose uniform
    `explore_u` (B, A) falls below epsilon bid with the uniform row
    `bids_u` (B, A, n) in place of their Q row, then all go through the
    same claim pass (JAX draws explore_u from k1 and bids_u from k2 of
    split(key))."""
    explore = (explore_u < epsilon) & training
    bids = torch.where(explore[..., None], bids_u, q)
    return coordinated_argmax(bids, masks, num_agvs, rack_start, active)


def coordinated_sample(logits: torch.Tensor, masks: torch.Tensor, num_agvs: int,
                       rack_start: int, gumbel: torch.Tensor,
                       active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Claim-masked sequential categorical sampling by the Gumbel-max trick
    (`gumbel` (B, A, n) standard Gumbel draws); the claim order comes from
    the clean masked logits, so sequential_log_prob is its exact density."""
    masked = torch.where(masks > 0, logits, BIG_NEG)
    if active is None:
        active = _ones_active(logits)
    return coordinated_argmax(masked + gumbel, masks, num_agvs, rack_start, active,
                              order_scores=masked.max(dim=-1).values)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax's form: shifted - log(sum(exp(shifted))), the
    shift by the row's maximum outside the gradient (JAX stops it)."""
    shifted = x - x.max(dim=-1, keepdim=True).values.detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def entropy_of(logp: torch.Tensor) -> torch.Tensor:
    """-(p * log p) summed over the last axis, terms of p <= 1e-8 left out
    (JAX's form, which keeps the gradient finite at masked actions)."""
    p = torch.exp(logp)
    return -(p * torch.where(p > 1e-8, logp, 0.0)).sum(-1)


def sequential_log_prob(logits: torch.Tensor, masks: torch.Tensor, actions: torch.Tensor,
                        num_agvs: int, rack_start: int,
                        active: Optional[torch.Tensor] = None):
    """Per-agent log-density and conditional entropy of coordinated_sample
    for the taken `actions` (B, A): replays the claim order, rebuilding
    each agent's menu from the earlier agents' taken actions. Returns
    (logp (B, A), entropy (B, A))."""
    masked = torch.where(masks > 0, logits, BIG_NEG)
    if active is None:
        active = _ones_active(logits)
    order = _selection_order(masked.max(dim=-1).values, active)
    logp = torch.zeros(logits.shape[:2], dtype=logits.dtype, device=logits.device)
    entropy = torch.zeros_like(logp)
    bidx = torch.arange(logits.shape[0], device=logits.device)
    for i, row, a in _claim_pass(masked, order, active, num_agvs, rack_start, actions):
        logp_row = log_softmax(row)
        logp[bidx, i] = logp_row.gather(-1, a[:, None])[:, 0]
        entropy[bidx, i] = entropy_of(logp_row)
    return logp, entropy


def busy_from_feats(agv_feats: torch.Tensor, picker_feats: torch.Tensor) -> torch.Tensor:
    """(B, A_total) bool: the agent already has a target (the env ignores
    its macro action, env/step.py Phase 1a). Node features encode 'no
    target' as ty = tx = 0."""
    at, pt = agv_feats[..., 5:7], picker_feats[..., 2:4]
    return torch.cat([~((at[..., 0] == 0) & (at[..., 1] == 0)),
                      ~((pt[..., 0] == 0) & (pt[..., 1] == 0))], dim=-1)
