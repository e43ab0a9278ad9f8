"""PyTorch + CUDA port of swarm_ode_tpu.

Ported so far:
  * the batched heuristic warehouse rollout: config/layout (copies of the
    JAX package's numpy code), env state, reset and step, the FIFO
    dispatcher, and the replan BFS, compacted (K1 ops/bfs_bitpack.py, K2
    ops/bfs_pallas.query_call) or full-field (K3 ops/bfs_pallas.bfs_dist_call,
    `bfs_backend="xla"`);
  * GDE trajectory serving, forward only: observations, temporal graphs,
    SAGE layers (sparse aggregation through the segment sum K4,
    ops/segment_pallas.py), odeint, the GDE model and `serving.make_gde_fn`.
The kernels' sources are under csrc/.

This package imports torch and numpy and never jax. Importing it builds
nothing; the CUDA kernels are compiled at first use on a GPU.

A function that takes a `device` (`env.state.make_params`,
`graphs.temporal.init_window`, the `convert.*_from_numpy` loaders) puts its
tensors on the card unless the caller passes `device="cpu"`; without a card
such a call raises. Everything else runs where its inputs lie.
"""

__version__ = "0.2.0"
