"""Spatio-temporal trajectory graphs over windows of observations (reference
GraphConverter, train_gde.py:108-271).

Counterpart of `swarm_ode_tpu/graphs/temporal.py`, batched: a window holds
B envs' last W frames as (B, W, N, D) with a (B,) count of valid frames.
A window is one graph of W*N nodes, frame-major (slot 0 oldest):
  * spatial edges inside each frame between agents closer than the
    distance threshold (train_gde.py:228-244), both directions;
  * temporal chain edges from agent i in frame k to agent i in frame k+1,
    when frame k+1 is valid (train_gde.py:246-267);
  * is_current marks the newest valid frame's agents.
Invalid slots are masked, never cut, so every shape is fixed.

Three forms of the same graph: `BatchedTemporalGraph` (structured: spatial
blocks and the frame count), `TemporalGraph` (dense (W*N, W*N) adjacency per
window) and `temporal_edges` (a padded edge list over the whole batch, for
the sparse path through K4).
"""
from __future__ import annotations

import dataclasses

import torch

from swarm_ode_tpu_torch.ops.segment import adjacency_to_edges


@dataclasses.dataclass
class TemporalWindow:
    """Rolling observation history of B envs (the reference's deque,
    train_gde.py:114)."""

    obs: torch.Tensor  # (B, W, N, D) float32, slot 0 oldest valid frame
    count: torch.Tensor  # (B,) int32 valid frames (<= W)


@dataclasses.dataclass
class TemporalGraph:
    """Dense form, one graph per window."""

    x: torch.Tensor  # (B, W*N, D) node features
    adj: torch.Tensor  # (B, W*N, W*N) bool adjacency [src, dst]
    node_mask: torch.Tensor  # (B, W*N) bool valid nodes
    is_current: torch.Tensor  # (B, W*N) bool newest valid frame's agents


@dataclasses.dataclass
class BatchedTemporalGraph:
    """Structured form: per-frame spatial blocks plus the frame count; the
    temporal chain is implied (ops/sage.temporal_mean_aggregate)."""

    x: torch.Tensor  # (B, W, N, D) node features
    spatial: torch.Tensor  # (B, W, N, N) bool within-frame adjacency [src, dst]
    frame_valid: torch.Tensor  # (B, W) bool
    count: torch.Tensor  # (B,) int32 valid frames


def init_window(batch: int, window: int, num_agents: int, obs_dim: int,
                device="cuda") -> TemporalWindow:
    return TemporalWindow(
        obs=torch.zeros(batch, window, num_agents, obs_dim, dtype=torch.float32, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def extract_positions(obs: torch.Tensor, num_agvs: int) -> torch.Tensor:
    """(..., N, 2) (y, x) per agent from zero-padded partial obs (..., N, D):
    AGVs at features 3, 4; pickers at 0, 1 (reference train_gde.py:186-208)."""
    N = obs.shape[-2]
    is_agv = (torch.arange(N, device=obs.device) < num_agvs)[:, None]
    return torch.where(is_agv, obs[..., 3:5], obs[..., 0:2])


def push_frame(w: TemporalWindow, obs: torch.Tensor) -> TemporalWindow:
    """Append a (B, N, D) frame to every window; a full window first shifts
    out its oldest frame (deque maxlen = W)."""
    B, W = w.obs.shape[:2]
    full = (w.count >= W)[:, None, None, None]
    new_obs = torch.where(full, torch.roll(w.obs, -1, dims=1), w.obs)
    slot = w.count.clamp(max=W - 1).long()
    new_obs[torch.arange(B, device=obs.device), slot] = obs.to(torch.float32)
    return TemporalWindow(obs=new_obs, count=(w.count + 1).clamp(max=W))


def build_temporal_batch(obs: torch.Tensor, count: torch.Tensor, num_agvs: int,
                         distance_threshold: float = 5.0) -> BatchedTemporalGraph:
    """Structured temporal graphs of B windows (train_gde.py:228-267).
    obs: (B, W, N, D); count: (B,) int."""
    B, W, N, _ = obs.shape
    frame_valid = torch.arange(W, device=obs.device)[None, :] < count[:, None]
    pos = extract_positions(obs, num_agvs)  # (B, W, N, 2)
    d2 = ((pos[:, :, :, None, :] - pos[:, :, None, :, :]) ** 2).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=obs.device)
    spatial = (d2 < distance_threshold**2) & ~eye & frame_valid[:, :, None, None]
    return BatchedTemporalGraph(x=obs, spatial=spatial, frame_valid=frame_valid,
                                count=count.to(torch.int32))


def dense_adjacency(g: BatchedTemporalGraph) -> torch.Tensor:
    """(B, W*N, W*N) bool: the spatial blocks on the diagonal, and the
    identity chain from frame k to frame k+1 where frame k+1 is valid."""
    B, W, N, _ = g.spatial.shape
    adj = torch.zeros(B, W, N, W, N, dtype=torch.bool, device=g.spatial.device)
    frames = torch.arange(W, device=adj.device)
    adj[:, frames, :, frames, :] = g.spatial.transpose(0, 1)
    eye = torch.eye(N, dtype=torch.bool, device=adj.device)
    link = eye[None, None] & g.frame_valid[:, 1:, None, None]  # (B, W-1, N, N)
    adj[:, frames[:-1], :, frames[1:], :] = link.transpose(0, 1)
    return adj.reshape(B, W * N, W * N)


def build_temporal_graph(w: TemporalWindow, num_agvs: int,
                         distance_threshold: float = 5.0) -> TemporalGraph:
    """Windows -> fixed-shape dense graphs (train_gde.py:116-184)."""
    B, W, N, D = w.obs.shape
    g = build_temporal_batch(w.obs, w.count, num_agvs, distance_threshold)
    slot = torch.arange(W * N, device=w.obs.device) // N
    cur = (w.count - 1).clamp(min=0)
    return TemporalGraph(
        x=w.obs.reshape(B, W * N, D),
        adj=dense_adjacency(g),
        node_mask=g.frame_valid.repeat_interleave(N, dim=1),
        is_current=(slot[None, :] == cur[:, None]) & (w.count > 0)[:, None],
    )


def edge_capacity(window: int, num_agents: int) -> int:
    """Most edges a window's graph can have: every ordered pair of distinct
    agents in every frame, plus the chain between consecutive frames."""
    return window * num_agents * (num_agents - 1) + (window - 1) * num_agents


def temporal_edges(g: BatchedTemporalGraph):
    """The batch's graphs as one padded edge list over B*W*N nodes (window
    b's nodes offset by b*W*N): (src, dst, valid), each (B*capacity,), in
    each window's row-major order (ops/segment.adjacency_to_edges). The
    capacity is `edge_capacity`, so no edge is ever dropped."""
    B, W, N, _ = g.x.shape
    cap = edge_capacity(W, N)
    src, dst, valid = adjacency_to_edges(dense_adjacency(g), cap)  # (B, cap)
    off = (torch.arange(B, device=src.device, dtype=torch.int32) * (W * N))[:, None]
    return (src + off).reshape(-1), (dst + off).reshape(-1), valid.reshape(-1)
