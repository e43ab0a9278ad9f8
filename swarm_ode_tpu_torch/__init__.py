"""PyTorch + CUDA port of swarm_ode_tpu.

The slice ported so far is the batched heuristic warehouse rollout:
config/layout (copies of the JAX package's numpy code), env state, reset and
step, the FIFO dispatcher, and the replan BFS with two hand-written CUDA
kernels (ops/bfs_bitpack.py, ops/bfs_pallas.py; sources under csrc/).

This package imports torch and numpy and never jax. Importing it builds
nothing; the CUDA kernels are compiled at first use on a GPU.
"""

__version__ = "0.1.0"
