"""Entry point of the flagship model: the port's counterpart of
`__graft_entry__.entry`.

    fn, args = entry()        # on the card; entry("cpu") on the CPU
    positions = fn(*args)     # (8, 5, 5, 2): each node's position at t = 1
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch
from swarm_ode_tpu_torch.models.gde import GraphODE

NUM_AGVS, OBS_DIM, BATCH, WINDOW, NUM_AGENTS = 3, 119, 8, 5, 5


def example_batch(device="cuda"):
    """The JAX entry's example batch, drawn from RandomState(0) in its order:
    obs (8, 5, 5, 119) in [0, 1), every window full, next positions (8, 5,
    2), weights 1."""
    rng = np.random.RandomState(0)
    obs = rng.rand(BATCH, WINDOW, NUM_AGENTS, OBS_DIM).astype(np.float32)
    next_pos = rng.rand(BATCH, NUM_AGENTS, 2).astype(np.float32)
    return {
        "obs": torch.from_numpy(obs).to(device),
        "count": torch.full((BATCH,), WINDOW, dtype=torch.int32, device=device),
        "next_pos": torch.from_numpy(next_pos).to(device),
        "weight": torch.ones(BATCH, dtype=torch.float32, device=device),
    }


def entry(device="cuda"):
    """(fn, args): the GraphODE trajectory model's whole-batch forward
    (structured aggregation, the path train_gde takes; euler over t = [0,
    1], hidden 64) on a batch of temporal warehouse graphs. fn(params, obs,
    count) -> (B, W, N, 2) positions at t = 1; args = (a state dict drawn
    by `GraphODE.init_` from seed 0, obs, count)."""
    model = GraphODE(node_dim=OBS_DIM, hidden_dim=64, ode_solver="euler").to(device)
    model.init_(torch.Generator(device).manual_seed(0))
    batch = example_batch(device)
    t_span = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)

    def fn(params, obs, count):
        g = build_temporal_batch(obs, count, NUM_AGVS)
        return functional_call(model, params, (g, t_span), strict=True)["trajectories"][1]

    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return fn, (params, batch["obs"], batch["count"])
