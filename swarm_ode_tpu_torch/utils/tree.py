"""Trees of tensors: dicts, lists, tuples and dataclasses (the port's
`EnvState`, `StepNoise`) whose leaves are tensors or anything else, which
passes through untouched. The JAX package's `jax.tree.map` and
`jax.tree.leaves` over such trees."""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch


def tree_map(fn: Callable[[torch.Tensor], object], tree):
    """`tree` with fn applied to each tensor leaf, in the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of `tree`, in tree_map's order."""
    leaves = []
    tree_map(lambda x: leaves.append(x) or x, tree)
    return leaves
