"""Conversion between the port's tensors and plain dicts of numpy arrays.

The JAX package's `EnvParams`, `EnvState` and `HeuristicState` cross into
this package as dicts of numpy arrays keyed by field name (the parity tests
build them with `np.asarray` on each JAX field), so nothing here imports
JAX. Batched JAX states (a vmapped reset or scan) carry the leading batch
dimension the port expects. The JAX state's PRNG `key` has no counterpart
and is ignored. The GDE's flax parameter tree converts to a state dict of
`models/gde.GraphODE` and back (`gde_params_from_numpy`,
`gde_params_to_numpy`), and the trainer's optimizer state to and from
optax's (clip_by_global_norm, adamw) chain state as numpy
(`adamw_state_from_numpy`, `adamw_state_to_numpy`). The MARL Q-networks
(models/hetero_gnn.py, models/gnode.py, models/gru.py), the mixers
(models/qmix.py) and the IQL / QMIX agent states (rl/dqn.DQNState:
parameters, target parameters, Adam's state, epsilon, step) convert the
same way, and so do the trajectory baselines (models/gru.py)
(`flax_params_to_state_dict`, `qnet_params_to_numpy`,
`agent_state_from_numpy`, `agent_state_to_numpy`). COMA's actors (the
encoder and the two heads), its critic and its whole state
(`coma_state_from_numpy`, `coma_state_to_numpy`), MAPPO's actor and
`ValueNet` critic (`mappo_params_from_numpy`) and optax's Adam state in
either layout (`adam_state_from_numpy`) convert the same way. The weights
of the five committed serving blobs (results_data/*.stablehlo) ship as
`weights/<blob>.npz`, read by `committed_params`.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from swarm_ode_tpu_torch.env.state import EnvParams, EnvState
from swarm_ode_tpu_torch.policies.heuristic import HeuristicState
from swarm_ode_tpu_torch.rl.coma import COMAState
from swarm_ode_tpu_torch.rl.dqn import DQNState
from swarm_ode_tpu_torch.utils.optim import AdamWState


# The committed blobs' weights: the flax tree's leaves under '/'-joined paths
# and `meta`, the blob's .stablehlo.json fields (JSON) with its sha256 and
# `zeroed`, the leaves the blob does not hold, stored as zeros
# (tests/torch_port_helpers.write_committed_weights writes them).
WEIGHTS_DIR = pathlib.Path(__file__).resolve().parent / "weights"


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _from_numpy(cls, arrays: Mapping[str, np.ndarray], device):
    return cls(**{
        f.name: _tensor(arrays[f.name], device) for f in dataclasses.fields(cls)
    })


def _to_numpy(obj) -> Dict[str, np.ndarray]:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
    return out


def env_state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> EnvState:
    """EnvState of B envs from (B, ...) arrays keyed by field name."""
    return _from_numpy(EnvState, arrays, device)


def env_state_to_numpy(state: EnvState) -> Dict[str, np.ndarray]:
    return _to_numpy(state)


def heuristic_state_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> HeuristicState:
    return _from_numpy(HeuristicState, arrays, device)


def heuristic_state_to_numpy(h: HeuristicState) -> Dict[str, np.ndarray]:
    return _to_numpy(h)


def env_params_from_numpy(fields: Mapping[str, object], device="cuda") -> EnvParams:
    """EnvParams from a dict of the JAX EnvParams' fields: numpy arrays for
    the tensors, Python values for the static scalars."""
    dev = torch.device(device)
    kwargs = {}
    for f in dataclasses.fields(EnvParams):
        if not f.init:  # derived in EnvParams.__post_init__
            continue
        if f.name == "device":
            kwargs[f.name] = dev
        elif isinstance(fields[f.name], np.ndarray):
            kwargs[f.name] = _tensor(fields[f.name], dev)
        else:
            kwargs[f.name] = fields[f.name]
    return EnvParams(**kwargs)


def env_params_to_numpy(params: EnvParams) -> Dict[str, object]:
    """The inverse of env_params_from_numpy (the device is dropped)."""
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().numpy()
        elif f.name != "device":
            out[f.name] = v
    return out


def env_state_to(state: EnvState, device) -> EnvState:
    """The same state with every tensor moved to `device`."""
    return EnvState(**{
        f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)
    })


def gde_params_from_numpy(tree: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """A GDE state dict (models/gde.GraphODE) from the JAX model's parameter
    tree as numpy: {"func": {"params": {convK: {"DenseSAGEConv_0": {"lin_l":
    {"kernel", "bias"}, "lin_r": {"kernel"}}}}}, "decoder": {"params":
    {"position_decoder": {"kernel", "bias"}}}}. A flax Dense kernel is
    (in, out) and a torch Linear weight (out, in): kernels are transposed,
    biases copied."""
    out = {}

    def linear(prefix, p):
        out[f"{prefix}.weight"] = _tensor(np.asarray(p["kernel"]).T, device)
        if "bias" in p:
            out[f"{prefix}.bias"] = _tensor(p["bias"], device)

    for conv, layer in tree["func"]["params"].items():
        for lin, p in layer["DenseSAGEConv_0"].items():
            linear(f"func.{conv}.DenseSAGEConv_0.{lin}", p)
    linear("decoder.position_decoder", tree["decoder"]["params"]["position_decoder"])
    return out


def gde_params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of gde_params_from_numpy: a flax-shaped tree of numpy
    arrays."""
    tree = {"func": {"params": {}}, "decoder": {"params": {}}}
    for name, v in state_dict.items():
        *path, leaf = name.split(".")
        node = tree[path[0]]["params"]
        for key in path[1:]:
            node = node.setdefault(key, {})
        a = v.detach().cpu().numpy()
        node["kernel" if leaf == "weight" else "bias"] = a.T.copy() if leaf == "weight" else a
    return tree


def adamw_state_from_numpy(opt_state, names: Sequence[str], device="cuda") -> AdamWState:
    """The trainer's AdamWState from optax's chain(clip_by_global_norm,
    adamw) state as numpy: (EmptyState(), (ScaleByAdamState(count, mu, nu),
    EmptyState(), EmptyState())), mu and nu flax-shaped trees like the
    parameters. `names`: the model's parameter names in its parameter order
    (`[n for n, _ in model.named_parameters()]`)."""
    _, (adam, *_) = opt_state
    count, mu, nu = adam
    mu, nu = gde_params_from_numpy(mu, device), gde_params_from_numpy(nu, device)
    return AdamWState(_tensor(np.asarray(count, np.int32), device), [mu[n] for n in names],
                      [nu[n] for n in names])


def adamw_state_to_numpy(state: AdamWState, names: Sequence[str]):
    """The inverse of adamw_state_from_numpy: ((), ((count, mu, nu), (), ())),
    optax's chain state with each EmptyState as (), so its leaves come in
    optax's order."""
    mu = gde_params_to_numpy(dict(zip(names, state.mu)))
    nu = gde_params_to_numpy(dict(zip(names, state.nu)))
    return ((), ((state.count.detach().cpu().numpy(), mu, nu), (), ()))


def flax_params_to_state_dict(tree: Mapping, device="cuda") -> Dict[str, torch.Tensor]:
    """A flax parameter tree as numpy (any nesting; the `params` collection
    levels are skipped) -> a state dict whose names are the tree's paths
    joined by dots: `<path>.weight` from a Dense `kernel`, transposed (flax
    (in, out), torch (out, in)), `<path>.bias` from `bias`. The port's MARL
    modules carry the flax names, so this is their state dict: a Q-network
    ({'params': {...}} for gnn, {'encoder': {'params': ...}, ...} for
    gnode), a mixer, or QMIX's {'q': ..., 'mixer': ...} (names `q.` and
    `mixer.`)."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path if k == "params" else path + [k])
            elif k == "kernel":
                out[".".join(path + ["weight"])] = _tensor(np.asarray(v).T, device)
            elif k == "bias":
                out[".".join(path + ["bias"])] = _tensor(v, device)
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path + [k])}")

    walk(tree, [])
    return out


def _nested(state_dict: Mapping[str, torch.Tensor]) -> dict:
    tree = {}
    for name, v in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        a = v.detach().cpu().numpy()
        node["kernel" if leaf == "weight" else "bias"] = a.T.copy() if leaf == "weight" else a
    return tree


def qnet_params_to_numpy(state_dict: Mapping[str, torch.Tensor], net: str) -> dict:
    """The inverse of flax_params_to_state_dict for a Q-network of `net`
    ('gnn', 'gru': one flax module, {'params': tree}; 'gnode' /
    'gnode_comm': a composite of flax modules, {child: {'params': tree}})."""
    tree = _nested(state_dict)
    if net in ("gnn", "gru"):
        return {"params": tree}
    if net in ("gnode", "gnode_comm"):
        return {k: {"params": v} for k, v in tree.items()}
    raise ValueError(f"net must be gnn, gru, gnode or gnode_comm, got {net!r}")


def mixer_params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> dict:
    return {"params": _nested(state_dict)}


def _agent_params_to_numpy(params: Mapping[str, torch.Tensor], net: str, algo: str) -> dict:
    if algo == "iql":
        return qnet_params_to_numpy(params, net)
    q = {k[2:]: v for k, v in params.items() if k.startswith("q.")}
    m = {k[6:]: v for k, v in params.items() if k.startswith("mixer.")}
    return {"q": qnet_params_to_numpy(q, net), "mixer": mixer_params_to_numpy(m)}


def agent_state_from_numpy(state, names: Optional[Sequence[str]] = None, device="cuda"):
    """rl/dqn.DQNState (also QMIX's) from a JAX DQNState / QMIXState with
    numpy leaves (`jax.tree.map(np.asarray, state)`): params and
    target_params flax trees, opt_state optax's chain(clip_by_global_norm,
    adam) state (EmptyState(), (ScaleByAdamState(count, mu, nu),
    EmptyState())), epsilon, step. `names` orders the parameters (the
    agent's own order, e.g. `list(agent.init(g).params)`); the tree's order
    by default."""
    params = flax_params_to_state_dict(state.params, device)
    names = list(names) if names is not None else list(params)
    if set(names) != set(params):
        raise KeyError(f"parameter names differ: {sorted(set(names) ^ set(params))}")
    target = flax_params_to_state_dict(state.target_params, device)
    _, (adam, *_) = state.opt_state
    count, mu, nu = adam
    mu, nu = flax_params_to_state_dict(mu, device), flax_params_to_state_dict(nu, device)
    return DQNState(
        params={n: params[n] for n in names},
        target_params={n: target[n] for n in names},
        opt_state=AdamWState(_tensor(np.asarray(count, np.int32), device),
                             [mu[n] for n in names], [nu[n] for n in names]),
        epsilon=_tensor(np.asarray(state.epsilon, np.float32), device),
        step=_tensor(np.asarray(state.step, np.int32), device))


def agent_state_to_numpy(state, net: str, algo: str) -> dict:
    """The inverse of agent_state_from_numpy, as a dict of the JAX state's
    fields; opt_state is ((), ((count, mu, nu), ())), optax's chain state
    with each EmptyState as (), so its leaves come in optax's order."""
    names = list(state.params)
    mu = _agent_params_to_numpy(dict(zip(names, state.opt_state.mu)), net, algo)
    nu = _agent_params_to_numpy(dict(zip(names, state.opt_state.nu)), net, algo)
    return {
        "params": _agent_params_to_numpy(state.params, net, algo),
        "target_params": _agent_params_to_numpy(state.target_params, net, algo),
        "opt_state": ((), ((state.opt_state.count.detach().cpu().numpy(), mu, nu), ())),
        "epsilon": state.epsilon.detach().cpu().numpy(),
        "step": state.step.detach().cpu().numpy(),
    }


def _adam_leaves(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside an adam or
    chain(clip_by_global_norm, adam) state as numpy: the first node with
    count, mu and nu, depth first."""
    if hasattr(opt_state, "mu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (list, tuple)):
        for node in opt_state:
            found = _adam_leaves(node)
            if found is not None:
                return found
    return None


def adam_state_from_numpy(opt_state, names: Sequence[str], device="cuda") -> AdamWState:
    """utils/optim.AdamWState from optax's adam(lr) state ((ScaleByAdamState,
    EmptyState())) or chain(clip_by_global_norm, adam) state ((EmptyState(),
    (ScaleByAdamState, EmptyState()))) with numpy leaves; mu and nu are
    flax trees like the parameters, taken in the order of `names`."""
    count, mu, nu = _adam_leaves(opt_state)
    mu, nu = flax_params_to_state_dict(mu, device), flax_params_to_state_dict(nu, device)
    return AdamWState(_tensor(np.asarray(count, np.int32), device), [mu[n] for n in names],
                      [nu[n] for n in names])


def _ordered(params: Dict[str, torch.Tensor], names: Optional[Sequence[str]]):
    """`params` in the order of `names` (their own order without), which
    must name exactly the same parameters."""
    if names is None:
        return params
    if set(names) != set(params):
        raise KeyError(f"parameter names differ: {sorted(set(names) ^ set(params))}")
    return {n: params[n] for n in names}


def coma_state_from_numpy(state, actor_names: Optional[Sequence[str]] = None,
                          critic_names: Optional[Sequence[str]] = None,
                          device="cuda") -> COMAState:
    """rl/coma.COMAState from a JAX COMAState with numpy leaves: actor_params
    {'encoder': {'params': ...}, 'agv': {'params': {'Dense_k'}}, 'picker':
    ...} (names `encoder.`, `agv.`, `picker.`), critic_params {'params':
    {'Dense_k'}}, each optimizer state optax's adam state, step. The name
    lists order the parameters (the agent's own order); the trees' order by
    default."""
    actor = _ordered(flax_params_to_state_dict(state.actor_params, device), actor_names)
    critic = _ordered(flax_params_to_state_dict(state.critic_params, device), critic_names)
    return COMAState(
        actor_params=actor, critic_params=critic,
        actor_opt=adam_state_from_numpy(state.actor_opt, list(actor), device),
        critic_opt=adam_state_from_numpy(state.critic_opt, list(critic), device),
        step=_tensor(np.asarray(state.step, np.int32), device))


def coma_state_to_numpy(state: COMAState) -> dict:
    """The parameters of a COMAState as the JAX state's flax trees:
    {'actor_params': {'encoder': {'params'}, 'agv': {'params'}, 'picker':
    {'params'}}, 'critic_params': {'params'}, 'step'}."""
    actor = _nested(state.actor_params)
    return {"actor_params": {k: {"params": v} for k, v in actor.items()},
            "critic_params": {"params": _nested(state.critic_params)},
            "step": state.step.detach().cpu().numpy()}


def mappo_params_from_numpy(actor_tree: Mapping, critic_tree: Mapping,
                            actor_names: Optional[Sequence[str]] = None,
                            critic_names: Optional[Sequence[str]] = None, device="cuda"):
    """(actor parameters, critic parameters) by name from JAX's MAPPO trees
    as numpy: the actor a Q-network of make_network's family, the critic a
    `ValueNet` ({'params': {'Dense_0', 'Dense_1', 'Dense_2'}}), each in the
    order of its names (rl/ppo.MappoRun's), which must match the tree's."""
    return (_ordered(flax_params_to_state_dict(actor_tree, device), actor_names),
            _ordered(flax_params_to_state_dict(critic_tree, device), critic_names))


def committed_params(name: str, device="cuda"):
    """(meta, state dict) of a committed serving blob's weights,
    `weights/<name>.npz`: for `gde_medium_h4w` a GDE state dict
    (models/gde.GraphODE), for a policy its network's (`meta["net"]`, the
    port's make_network family)."""
    tree = {}
    with np.load(WEIGHTS_DIR / f"{name}.npz") as f:
        meta = json.loads(str(f["meta"]))
        for key in f.files:
            if key == "meta":
                continue
            *path, leaf = key.split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    if "kind" in meta:
        return meta, flax_params_to_state_dict(tree, device)
    return meta, gde_params_from_numpy(tree, device)
