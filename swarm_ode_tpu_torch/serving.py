"""Trajectory serving for the GDE model.

Counterpart of the GDE part of `swarm_ode_tpu/serving.py` (`make_gde_fn`).
The predictor serves windows of observations as they come from a rollout
(env/observations.observe, graphs/temporal.push_frame): it builds each
window's temporal graph, integrates the model over t = 0..horizon, and
returns the newest valid frame's predicted positions. A batch of windows is
one pass through `GraphODE.apply_batched`, with SAGE aggregation on the
graphs' padded edge list (K4 on the card); one window is a batch of one.
Exporting the model (jax.export in the JAX package) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch, temporal_edges
from swarm_ode_tpu_torch.models.gde import GraphODE


def make_gde_fn(model: GraphODE, params: Optional[Mapping[str, torch.Tensor]] = None,
                distance_threshold: float = 5.0, horizon: int = 4) -> Callable:
    """The model as a serving function, after loading `params` (a state
    dict, e.g. from convert.gde_params_from_numpy) into it when given.

    predict(obs, count): obs (W, N, D) float32 and count () int32 give
    (horizon+1, N, 2), the predicted (y, x) of the newest valid frame's
    agents at t = 0..horizon, as the JAX function does; obs (B, W, N, D) and
    count (B,) give (B, horizon+1, N, 2), the same as jax.vmap of it."""
    if params is not None:
        model.load_state_dict(params)

    @torch.no_grad()
    def predict(obs: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        single = obs.dim() == 3
        if single:
            obs, count = obs[None], count.reshape(1)
        t_span = torch.arange(horizon + 1, dtype=torch.float32, device=obs.device)
        g = build_temporal_batch(obs, count, model.num_agvs, distance_threshold)
        traj = model.apply_batched(g, t_span, edges=temporal_edges(g))["trajectories"]
        B = obs.shape[0]
        newest = (count.long() - 1).clamp(min=0)
        out = traj[:, torch.arange(B, device=obs.device), newest].transpose(0, 1)
        return out[0] if single else out

    return predict
