"""Checkpoint and resume on `torch.save` / `torch.load`.

Counterpart of `swarm_ode_tpu/utils/checkpoint.py` (orbax there), with its
contract: `save(step, state, force)`, `latest_step()`, `restore(state_like,
step, partial)`, `max_to_keep` and `close()`. A state is a nested dict (lists
and tuples too) of tensors, numpy arrays and Python numbers; each step is
one file, `<directory>/<step>.pt`, written to a temporary name and renamed,
so a step on disk is whole. Tensors are stored on the CPU, numpy arrays as
tensors, and `restore` gives each leaf back in the form and on the device
of the matching leaf of `state_like`, bit for bit. Files are read with
`torch.load(weights_only=True)`, which unpickles tensors and containers
only.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _to_storable(x):
    if isinstance(x, dict):
        return {k: _to_storable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_storable(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x, copy=True))
    return x


def _like(saved, like, path: str):
    """`saved` in the structure and leaf forms of `like`."""
    if isinstance(like, dict):
        missing = set(like) - set(saved)
        if missing:
            raise KeyError(f"checkpoint has no {sorted(missing)} under {path or 'the root'}")
        return {k: _like(saved[k], v, f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(saved) != len(like):
            raise ValueError(f"{path}: {len(saved)} entries saved, {len(like)} expected")
        out = [_like(s, v, f"{path}/{i}") for i, (s, v) in enumerate(zip(saved, like))]
        return type(like)(out) if type(like) in (list, tuple) else type(like)(*out)
    if isinstance(like, (torch.Tensor, np.ndarray, np.generic)):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"{path}: saved shape {tuple(saved.shape)}, expected "
                             f"{tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            return saved.to(device=like.device, dtype=like.dtype)
        return saved.numpy().astype(like.dtype, copy=False)
    return type(like)(saved)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(n[:-3]) for n in os.listdir(self.directory)
                      if n.endswith(".pt") and n[:-3].isdigit())

    def save(self, step: int, state: Dict[str, Any], force: bool = False):
        """state: a nested dict, e.g. {'params': ..., 'opt_state': ...,
        'epoch': ...}. An existing checkpoint at `step` raises
        FileExistsError unless `force`, which overwrites it. Only the
        newest `max_to_keep` steps stay on disk."""
        path = self._path(step)
        if os.path.exists(path) and not force:
            raise FileExistsError(f"a checkpoint at step {step} exists: {path}")
        tmp = path + ".tmp"
        torch.save(_to_storable(state), tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Dict[str, Any], step: Optional[int] = None,
                partial: bool = False):
        """The checkpoint at `step` (default the newest) in the structure,
        shapes, dtypes and devices of `state_like`. `partial=True` restores
        only the keys present in `state_like` (e.g. params only from a full
        training checkpoint); otherwise the checkpoint must hold exactly
        those keys. Returns None if no checkpoint exists."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if not partial and set(saved) != set(state_like):
            raise KeyError(f"checkpoint keys {sorted(saved)}, expected {sorted(state_like)}")
        return _like(saved, state_like, "")

    def close(self):
        """Nothing stays open between calls; kept for the JAX class's
        contract."""
