"""Padded edge lists and segment reductions: the sparse message-passing path.

Counterpart of `swarm_ode_tpu/ops/segment.py`. Edge lists have a fixed
capacity and a validity mask (no host synchronisation to size them), and
every segment sum goes through K4 (`ops/segment_pallas`).
`gather_scatter_mean` is the sparse form of `ops/sage.masked_mean_aggregate`:
one K4 launch over a plan of the edges (`segment_pallas.segment_plan`) that
reads the sources' rows through the plan, so no message matrix is built.
The GDE server aggregates with it, planning once per batch (models/gde.py).
"""
from __future__ import annotations

from typing import Tuple

import torch

from swarm_ode_tpu_torch.ops.segment_pallas import (
    segment_plan,
    segment_sum_call,
    segment_sum_planned,
)


def adjacency_to_edges(
    adj: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense (..., S, T) bool adjacency -> padded edge lists.

    Returns (src, dst, valid), each (..., capacity): the first `capacity`
    edges in row-major (src-major) order, as `jnp.nonzero(size=capacity,
    fill_value=S*T)` gives them; padding slots read (S-1, T-1) and are not
    valid, and edges beyond the capacity are dropped."""
    S, T = adj.shape[-2:]
    lead = adj.shape[:-2]
    flat = adj.reshape(-1, S * T)
    # Slot of each edge in its list, from a running count (no nonzero(),
    # which would synchronise with the host to size its output).
    slot = torch.cumsum(flat, dim=1) - 1
    keep = flat & (slot < capacity)
    idx = torch.full((flat.shape[0], capacity + 1), S * T, dtype=torch.int64, device=adj.device)
    cells = torch.arange(S * T, device=adj.device).expand_as(slot)
    # Cells that are not kept all land in the spare last slot, cut off below.
    idx.scatter_(1, torch.where(keep, slot, capacity), cells)
    idx = idx[:, :capacity]
    valid = idx < S * T
    idx = idx.clamp(max=S * T - 1)
    src = (idx // T).to(torch.int32)
    dst = (idx % T).to(torch.int32)
    shape = (*lead, capacity)
    return src.reshape(shape), dst.reshape(shape), valid.reshape(shape)


def segment_sum(data, segment_ids, num_segments: int, valid=None) -> torch.Tensor:
    """Masked segment sum: rows of `data` (E, D) summed into `segment_ids`
    buckets; invalid and out-of-range rows are dropped (K4 on the card)."""
    return segment_sum_call(data, segment_ids, num_segments, valid)


def segment_count(segment_ids, num_segments: int, valid=None,
                  dtype=torch.float32) -> torch.Tensor:
    """(num_segments, 1) number of valid, in-range rows per segment."""
    ones = torch.ones(segment_ids.shape[0], 1, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, valid)


def segment_mean(data, segment_ids, num_segments: int, valid=None,
                 count=None) -> torch.Tensor:
    """Masked segment mean. `count` is `segment_count` of the same ids and
    mask: a caller that averages over one edge list many times computes it
    once and passes it in."""
    s = segment_sum(data, segment_ids, num_segments, valid)
    if count is None:
        count = segment_count(segment_ids, num_segments, valid, data.dtype)
    return s / count.clamp(min=1.0)


def gather_scatter_mean(x_src, src, dst, valid, num_dst: int, plan=None) -> torch.Tensor:
    """Sparse equivalent of ops.sage.masked_mean_aggregate: source features
    (S, D) gathered along the edges and mean-scattered into `num_dst`
    destinations, in one K4 launch. Sources outside [0, S) are read as a
    JAX gather reads them (S added once to a negative one, then clamped).
    `plan` is `segment_plan(dst, valid, num_dst, rows=src, num_rows=S)`: a
    caller that averages over one edge list many times builds it once and
    passes it in."""
    if plan is None:
        plan = segment_plan(dst, valid, num_dst, rows=src, num_rows=x_src.shape[0])
    return segment_sum_planned(x_src, *plan, mean=True)
