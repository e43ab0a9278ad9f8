"""Serving: greedy or sampled dispatch policies, and the GDE's trajectories.

Counterpart of `swarm_ode_tpu/serving.py`'s `make_policy_fn` and
`make_gde_fn`, without the export (jax.export in the JAX package).

`make_policy_fn` serves a Q-network (or any network with AGV and picker
value heads) as a function of the observation alone: the hetero graph,
the valid-action masks (graphs/hetero.masks_from_feats) and the busy flags
(rl/coordination.busy_from_feats) all come from the observation, so a
server needs no simulator state.

The GDE predictor serves windows of observations as they come from a rollout
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

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.env.step import draw_gumbel
from swarm_ode_tpu_torch.graphs.hetero import hetero_graph_from_obs, masks_from_feats, split_observation
from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch, temporal_edges
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.rl import coordination


def make_policy_fn(env_params: EnvParams, net: torch.nn.Module,
                   params: Optional[Mapping[str, torch.Tensor]] = None,
                   coordinated: bool = False, temperature: float = 0.0) -> Callable:
    """A network as a dispatch policy, after loading `params` (the
    network's state dict, e.g. run_rl.agent_params of an agent state) when
    given.

    temperature == 0: policy(obs) -> actions, greedy over the valid
    actions, through the claim auction when `coordinated`.
    temperature > 0: policy(obs, gumbel=None, generator=None) samples from
    softmax(scores / temperature) under the claim auction
    (rl/coordination.coordinated_sample) with the standard Gumbel draws
    `gumbel` (same shape as the scores) or draws from `generator`.
    obs is (B, A_total, obs_len) (actions (B, A_total) int32) or one env's
    (A_total, obs_len) (actions (A_total,))."""
    if params is not None:
        net.load_state_dict(params)
    rack_start = 1 + env_params.num_goals

    def scores_and_masks(obs):
        g = hetero_graph_from_obs(env_params, obs)
        out = net(g)
        scores = torch.cat([out["agv_q_values"], out["picker_q_values"]], dim=-2)
        a_f, p_f, l_f = split_observation(env_params, obs)
        masks = masks_from_feats(env_params, a_f, p_f, l_f)
        return scores, masks, ~coordination.busy_from_feats(a_f, p_f)

    def batched(fn):
        @torch.no_grad()
        def policy(obs, *args, **kwargs):
            if obs.dim() == 2:
                return fn(obs[None], *args, **kwargs)[0]
            return fn(obs, *args, **kwargs)
        return policy

    if temperature > 0:
        temps = {}  # the temperature as a 0-d tensor on each device it serves

        @batched
        def sample_policy(obs, gumbel=None, generator=None):
            scores, masks, active = scores_and_masks(obs)
            if gumbel is None:
                gumbel = draw_gumbel(scores.shape, generator, scores.device)
            elif gumbel.dim() == 2:
                gumbel = gumbel[None]
            # The temperature divides as a tensor: CUDA turns a division by
            # a Python scalar into a product with its reciprocal.
            temp = temps.setdefault(scores.device, torch.tensor(
                temperature, dtype=torch.float32, device=scores.device))
            return coordination.coordinated_sample(
                scores / temp, masks, env_params.num_agvs, rack_start,
                gumbel, active=active)

        return sample_policy

    @batched
    def greedy_policy(obs):
        scores, masks, active = scores_and_masks(obs)
        if coordinated:
            return coordination.coordinated_argmax(scores, masks, env_params.num_agvs,
                                                   rack_start, active=active)
        return torch.where(masks > 0, scores, -torch.inf).argmax(dim=-1).to(torch.int32)

    return greedy_policy


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
