"""Conversion between the port's tensors and plain dicts of numpy arrays.

The JAX package's `EnvParams`, `EnvState` and `HeuristicState` cross into
this package as dicts of numpy arrays keyed by field name (the parity tests
build them with `np.asarray` on each JAX field), so nothing here imports
JAX. Batched JAX states (a vmapped reset or scan) carry the leading batch
dimension the port expects. The JAX state's PRNG `key` has no counterpart
and is ignored. The GDE's flax parameter tree converts to a state dict of
`models/gde.GraphODE` and back (`gde_params_from_numpy`,
`gde_params_to_numpy`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from swarm_ode_tpu_torch.env.state import EnvParams, EnvState
from swarm_ode_tpu_torch.policies.heuristic import HeuristicState


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
