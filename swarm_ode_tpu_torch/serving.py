"""Serving: greedy or sampled dispatch policies and the GDE's trajectories,
exported as artifacts that serve without the model's Python code.

Counterpart of `swarm_ode_tpu/serving.py` (make_policy_fn :36, make_gde_fn
:95, export_fn :123, export_policy :137, export_gde :150, load_gde :160,
load_policy :173) and of `scripts/serve_policy.py` (`python -m
swarm_ode_tpu_torch.serving --blob <artifact>`).

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

Both are `nn.Module`s, so `torch.export` traces them: `export_policy` and
`export_gde` serialise the program with its weights to bytes
(torch.export.save), and `load_policy` / `load_gde` read it back
(torch.export.load) onto a device (torch.export.passes.move_to_device_pass),
so an artifact exported on the CPU serves on the card and the reverse, as
JAX lowers each blob for both its platforms. The example's shapes fix the
artifact's shapes, as they fix a blob's. Loading needs the port's op
library registered, which a StableHLO blob does not: the GDE aggregates
through the custom op `swarm_ode_tpu_torch::segment_sum_planned`
(ops/segment_pallas.py, K4 on the card), which importing this module
registers.

A sampled policy's artifact takes its draws as an input, (obs, gumbel) ->
actions, with `gumbel` the standard Gumbel draws of the scores' shape: the
JAX blob takes a uint32 seed and runs threefry inside, which torch cannot
replay, and an exported program takes no torch.Generator. The server still
controls the randomness.
"""
from __future__ import annotations

import io
from typing import Callable, Mapping, Optional

import torch
from torch.export.passes import move_to_device_pass

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.env.step import draw_gumbel
from swarm_ode_tpu_torch.graphs.hetero import hetero_graph_from_obs, masks_from_feats, split_observation
from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch, temporal_edges
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.rl import coordination


class Policy(torch.nn.Module):
    """A network as a dispatch policy; see `make_policy_fn`."""

    def __init__(self, env_params: EnvParams, net: torch.nn.Module, coordinated: bool,
                 temperature: float):
        super().__init__()
        self.env_params, self.net = env_params, net
        self.coordinated, self.temperature = coordinated, temperature

    def _scores_and_masks(self, obs):
        p = self.env_params
        out = self.net(hetero_graph_from_obs(p, obs))
        scores = torch.cat([out["agv_q_values"], out["picker_q_values"]], dim=-2)
        a_f, p_f, l_f = split_observation(p, obs)
        return scores, masks_from_feats(p, a_f, p_f, l_f), ~coordination.busy_from_feats(a_f, p_f)

    @torch.no_grad()
    def forward(self, obs: torch.Tensor, gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        single = obs.dim() == 2
        if single:
            obs = obs[None]
        scores, masks, active = self._scores_and_masks(obs)
        rack_start = 1 + self.env_params.num_goals
        if self.temperature > 0:
            if gumbel is None:
                gumbel = draw_gumbel(scores.shape, generator, scores.device)
            elif gumbel.dim() == 2:
                gumbel = gumbel[None]
            # The temperature divides as a tensor: CUDA turns a division by
            # a Python scalar into a product with its reciprocal.
            temp = torch.full((), self.temperature, dtype=torch.float32, device=scores.device)
            acts = coordination.coordinated_sample(scores / temp, masks, self.env_params.num_agvs,
                                                   rack_start, gumbel, active=active)
        elif gumbel is not None or generator is not None:
            raise ValueError("a greedy policy takes no random draws")
        elif self.coordinated:
            acts = coordination.coordinated_argmax(scores, masks, self.env_params.num_agvs,
                                                   rack_start, active=active)
        else:
            acts = torch.where(masks > 0, scores, -torch.inf).argmax(dim=-1).to(torch.int32)
        return acts[0] if single else acts


def make_policy_fn(env_params: EnvParams, net: torch.nn.Module,
                   params: Optional[Mapping[str, torch.Tensor]] = None,
                   coordinated: bool = False, temperature: float = 0.0) -> Policy:
    """A network as a dispatch policy, after loading `params` (the
    network's state dict, e.g. run_rl.agent_params of an agent state, or
    convert.committed_params) when given.

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
    return Policy(env_params, net, coordinated, temperature)


class GDEPredictor(torch.nn.Module):
    """The GDE as a serving function; see `make_gde_fn`."""

    def __init__(self, model: GraphODE, distance_threshold: float, horizon: int,
                 num_agvs: Optional[int] = None):
        super().__init__()
        self.model, self.distance_threshold, self.horizon = model, distance_threshold, horizon
        self.num_agvs = model.num_agvs if num_agvs is None else num_agvs

    @torch.no_grad()
    def forward(self, obs: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        single = obs.dim() == 3
        if single:
            obs, count = obs[None], count.reshape(1)
        t_span = torch.arange(self.horizon + 1, dtype=torch.float32, device=obs.device)
        g = build_temporal_batch(obs, count, self.num_agvs, self.distance_threshold)
        traj = self.model.apply_batched(g, t_span, edges=temporal_edges(g))["trajectories"]
        B = obs.shape[0]
        newest = (count.long() - 1).clamp(min=0)
        out = traj[:, torch.arange(B, device=obs.device), newest].transpose(0, 1)
        return out[0] if single else out


def make_gde_fn(model: GraphODE, params: Optional[Mapping[str, torch.Tensor]] = None,
                distance_threshold: float = 5.0, horizon: int = 4,
                num_agvs: Optional[int] = None) -> GDEPredictor:
    """The model as a serving function, after loading `params` (a state
    dict, e.g. from convert.gde_params_from_numpy) into it when given. The
    windows' graphs take the first `num_agvs` agents as AGVs (default the
    model's `num_agvs`; JAX's evaluate_gde passes the dataset's).

    predict(obs, count): obs (W, N, D) float32 and count () int32 give
    (horizon+1, N, 2), the predicted (y, x) of the newest valid frame's
    agents at t = 0..horizon, as the JAX function does; obs (B, W, N, D) and
    count (B,) give (B, horizon+1, N, 2), the same as jax.vmap of it."""
    if params is not None:
        model.load_state_dict(params)
    return GDEPredictor(model, distance_threshold, horizon, num_agvs)


def export_fn(fn: torch.nn.Module, *example_args: torch.Tensor) -> bytes:
    """Trace a module of tensors (torch.export.export) at the example's
    shapes, dtypes and device, and serialise the program with its weights
    (torch.export.save)."""
    with torch.no_grad():
        program = torch.export.export(fn, tuple(example_args))
    # The artifact keeps the program and its weights, not the example (a
    # GDE batch of 512 medium windows is 125 MB).
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_policy(policy: Policy, example_obs: torch.Tensor, stochastic: bool = False) -> bytes:
    """Serialise a policy for observations of `example_obs`'s shape
    ((A_total, obs_len), or (B, A_total, obs_len)). stochastic=True exports
    a sampled policy's (obs, gumbel) calling convention."""
    if stochastic != (policy.temperature > 0):
        raise ValueError(
            f"stochastic={stochastic} for a policy at temperature {policy.temperature}")
    if not stochastic:
        return export_fn(policy, example_obs)
    gumbel = example_obs.new_zeros(*example_obs.shape[:-1], policy.env_params.num_actions)
    return export_fn(policy, example_obs, gumbel)


def export_gde(predictor: GDEPredictor, window: int, num_agents: int, obs_dim: int,
               batch: Optional[int] = None) -> bytes:
    """Serialise a make_gde_fn predictor for (W, N, D) windows, or for
    batches of `batch` windows, on the device of its model."""
    shape = (window, num_agents, obs_dim) if batch is None else (batch, window, num_agents, obs_dim)
    device = next(predictor.parameters()).device
    count = torch.full(shape[:-3], window, dtype=torch.int32, device=device)
    return export_fn(predictor, torch.zeros(shape, device=device), count)


def _load(blob: bytes, device):
    """The exported program in `blob`, moved to `device`, as a module, and
    the number of its inputs."""
    program = torch.export.load(io.BytesIO(blob))
    program = move_to_device_pass(program, device)
    return program.module(), len(program.graph_signature.user_inputs)


def load_gde(blob: bytes, device="cuda") -> Callable:
    """Deserialise an exported trajectory model onto `device` into
    (window_obs, count) -> (horizon+1, N, 2) (batched as it was exported)."""
    module, _ = _load(blob, device)

    @torch.no_grad()
    def predict(obs, count):
        return module(torch.as_tensor(obs, dtype=torch.float32, device=device),
                      torch.as_tensor(count, dtype=torch.int32, device=device))

    return predict


def load_policy(blob: bytes, device="cuda") -> Callable:
    """Deserialise an exported policy onto `device` into a callable
    obs[, gumbel] -> actions (gumbel required iff the artifact was exported
    stochastic). The model's Python code and parameters are not needed."""
    module, n_args = _load(blob, device)

    @torch.no_grad()
    def policy(obs, gumbel=None):
        obs = torch.as_tensor(obs, dtype=torch.float32, device=device)
        if n_args == 1:
            if gumbel is not None:
                raise ValueError("greedy policy artifact: it takes no gumbel")
            return module(obs)
        if gumbel is None:
            raise ValueError("stochastic policy artifact: pass gumbel=<standard Gumbel draws>")
        return module(obs, torch.as_tensor(gumbel, dtype=torch.float32, device=device))

    return policy


def main(argv=None) -> None:
    """Run episodes with an exported policy artifact and print the
    reference-style stat line for each (scripts/serve_policy.py)."""
    import argparse
    import pathlib

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.utils.metrics import pick_rate

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--blob", required=True, help="policy artifact (export_policy's bytes)")
    p.add_argument("--env_id", default="tarware-medium-19agvs-9pickers-partialobs-v1")
    p.add_argument("--num_episodes", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="serve on the CPU (default: the card)")
    args = p.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    cfg = EnvConfig.from_env_id(args.env_id)
    params = make_params(cfg, build_layout(cfg), device)
    steps = cfg.max_steps or 500
    policy = load_policy(pathlib.Path(args.blob).read_bytes(), device)
    for ep in range(args.num_episodes):
        gen = torch.Generator(device=device).manual_seed(args.seed + ep)
        es = step_mod.reset(params, 1, gen)
        ret, deliv, clash = 0.0, 0, 0
        for _ in range(steps):
            actions = policy(observe(params, es)[0])
            es, rew, _, info = step_mod.step(params, es, actions[None], generator=gen)
            ret += float(rew.sum())
            deliv += int(info["shelf_deliveries"].sum())
            clash += int(info["clashes"].sum())
        print(f"Episode {ep}: | [Overall Pick Rate={pick_rate(deliv, steps):.2f}]"
              f"| [Global return={ret:.2f}]"
              f"| [Total shelf deliveries={deliv}]"
              f"| [Total clashes={clash}]", flush=True)


if __name__ == "__main__":
    main()
