"""The yardstick's arithmetic: the card's published peaks, the GDE's model
FLOPs from the configuration's shapes, and the bytes and operations of the
two hand-written kernels the cells time (K1, the replan query; K4, the
planned segment mean), counted from each launch's arguments.

The kernel counts are copies of `chip_smoke.py`'s (`bound`, `query_bound`,
and the planned K4 bound of `check_k4`), kept here so that the benchmark
reads nothing of the program's files.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W: HBM bytes/s and the float32 rate outside
# the tensor cores (the configurations run float32 with TF32 off).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "f32_flops_per_s": F32_FLOPS_PER_S}


def bound_s(nbytes: float, ops: float):
    """(seconds, bound_by): the least time for `nbytes` moved and `ops` done
    at the published peaks, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes_ops(rows: int, cells: int, envs: int):
    """K1 on `rows` query rows of `cells` walled cells, reading the
    occupancy rows of `envs` envs: each env's occupancy row and the two class
    base rows once (a byte a cell), 16 bytes a row in (env, class, target,
    own cell) and 8 out; a BFS visits each cell once, four neighbour reads
    and an add (5 operations a cell)."""
    return envs * cells + 2 * cells + 24 * rows, 5 * rows * cells


def k4_bytes_ops(width: int, valid_edges: int, distinct_sources: int, nodes: int):
    """K4's planned mean over `valid_edges` edges into `nodes` nodes of
    `width` float32 features: each distinct source row read once, the plan
    (a row id an edge, an offset a node), the output written once; an add
    per (edge, feature) and a division per output element."""
    nbytes = 4 * (distinct_sources * width + valid_edges + nodes + 1 + nodes * width)
    return nbytes, valid_edges * width + nodes * width


def sage_layer_flops(d_in: int, d_out: int) -> int:
    """Model FLOPs of one SAGE layer at one node: the two dense products,
    lin_l on the aggregate and lin_r on the node, 2 * d_in * d_out each."""
    return 2 * (2 * d_in * d_out)


def gde_window_flops(node_dim: int, hidden: int, window: int, agents: int, horizon: int) -> int:
    """Model FLOPs of one window forward through the GDE: the three SAGE
    layers (node -> hidden -> hidden -> node) at each of the `horizon` euler
    function evaluations over all window * agents nodes, and the position
    decoder (node -> 2) at each of the horizon + 1 solution times. The
    aggregation's adds and the elementwise passes are not model FLOPs."""
    nodes = window * agents
    per_node = (sage_layer_flops(node_dim, hidden) + sage_layer_flops(hidden, hidden)
                + sage_layer_flops(hidden, node_dim))
    return horizon * nodes * per_node + (horizon + 1) * nodes * 2 * node_dim * 2


# Forward and backward of a training step, counted as three forwards.
TRAIN_FLOPS_FACTOR = 3
