"""GraphSAGE message passing (mean aggregation), dense and sparse.

Counterpart of `swarm_ode_tpu/ops/sage.py`. Equivalent to PyG SAGEConv with
mean aggregation (the only configuration the reference uses:
train_gde.py:27-29, run_gnode.py:89-95):
    out[d] = lin_l(mean_{s : adj[s, d]} x_src[s]) + lin_r(x_dst[d])
`lin_l` has a bias and `lin_r` none, as in the JAX modules, so a flax
parameter tree converts by transposing its kernels (convert.py).

Aggregation comes in three forms that compute the same means:
`masked_mean_aggregate` (dense adjacency, a batched matrix product),
`temporal_mean_aggregate` (the structured temporal graph: per-frame blocks
and a frame shift) and `edge_mean_aggregate` (a padded edge list through
ops/segment.gather_scatter_mean, K4 on the card).
"""
from __future__ import annotations

import torch
from torch import nn

from swarm_ode_tpu_torch.ops.segment import gather_scatter_mean


def masked_mean_aggregate(x_src, adj, node_mask=None):
    """Mean over in-neighbours: (adj^T @ x_src) / deg, zero where deg == 0.

    x_src: (..., S, D); adj: (..., S, T) bool [src, dst]; node_mask:
    (..., S) bool valid sources or None. Returns (..., T, D)."""
    a = adj.to(x_src.dtype)
    if node_mask is not None:
        a = a * node_mask.to(x_src.dtype)[..., :, None]
    deg = a.sum(dim=-2)  # (..., T)
    agg = a.transpose(-1, -2) @ x_src
    return agg / deg.clamp(min=1.0)[..., None]


def temporal_mean_aggregate(x, spatial, frame_valid):
    """In-neighbour mean over a batch of temporal graphs in structured form:
    exactly `masked_mean_aggregate` on the dense adjacency that
    graphs/temporal.dense_adjacency builds, without building it.

    x: (B, W, N, D); spatial: (B, W, N, N) [src, dst]; frame_valid: (B, W).
    Returns (B, W, N, D). The spatial blocks already carry frame validity,
    and a temporal edge into a valid frame k always has a valid source
    frame k-1 (validity is a prefix)."""
    a = spatial.to(x.dtype)
    deg_sp = a.sum(dim=2)  # (B, W, N) in-degree from spatial edges
    agg = torch.einsum("bwij,bwid->bwjd", a, x)
    # Temporal chain: node (k, j) receives x[k-1, j] when frame k is valid.
    first = torch.arange(x.shape[1], device=x.device) == 0
    has_prev = frame_valid & ~first[None, :]  # (B, W)
    prev = torch.roll(x, 1, dims=1)
    agg = agg + torch.where(has_prev[..., None, None], prev, 0.0)
    deg = deg_sp + has_prev[..., None].to(x.dtype)
    return agg / deg.clamp(min=1.0)[..., None]


def edge_mean_aggregate(x, edges, plan=None):
    """`temporal_mean_aggregate` over the padded edge list that
    graphs/temporal.temporal_edges builds for the same batch: every node's
    features gathered along its edges and mean-scattered into their
    destinations (K4 on the card). x: (B, W, N, D); edges: (src, dst,
    valid) over the B*W*N flattened nodes; plan: their
    ops/segment_pallas.segment_plan with the sources as rows, built here
    when not given."""
    src, dst, valid = edges
    B, W, N, D = x.shape
    out = gather_scatter_mean(x.reshape(B * W * N, D), src, dst, valid, B * W * N, plan)
    return out.view(B, W, N, D)


class DenseSAGEConv(nn.Module):
    """SAGEConv(mean) over a dense boolean adjacency (torch_geometric
    SAGEConv(in, out) semantics): `lin_l` on the aggregate (with bias),
    `lin_r` on the root (no bias). Nodes without in-neighbours get only the
    root term, as PyG's scatter-mean gives them zeros."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_l = nn.Linear(in_features, features, bias=True)
        self.lin_r = nn.Linear(in_features, features, bias=False)

    def combine(self, agg, x_dst):
        """lin_l(agg) + lin_r(x_dst): the layer given its aggregate."""
        return self.lin_l(agg) + self.lin_r(x_dst)

    def forward(self, x_src, x_dst, adj, src_mask=None):
        return self.combine(masked_mean_aggregate(x_src, adj, src_mask), x_dst)


class HomoSAGE(nn.Module):
    """Homogeneous wrapper (x_src == x_dst); the inner layer keeps the flax
    module's name, so parameter names match the JAX tree."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.DenseSAGEConv_0 = DenseSAGEConv(in_features, features)

    def forward(self, x, adj, node_mask=None):
        return self.DenseSAGEConv_0(x, x, adj, node_mask)


class TemporalSAGE(nn.Module):
    """SAGEConv(mean) over a `BatchedTemporalGraph`'s structured adjacency,
    with the same parameters as `HomoSAGE`'s inner layer."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.lin_l = nn.Linear(in_features, features, bias=True)
        self.lin_r = nn.Linear(in_features, features, bias=False)

    def forward(self, x, spatial, frame_valid):
        agg = temporal_mean_aggregate(x, spatial, frame_valid)
        return self.lin_l(agg) + self.lin_r(x)
