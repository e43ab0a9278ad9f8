"""Inputs made from the seed on the card: the GDE cells' synthetic corpus of
observation episodes, the benchmark's weights, and the seeds of every stream.

The corpus stands for datagen's logged episodes at the flagship's shape: E
episodes of T steps of N agents x D uint8 features. Every feature is a 0/1
flag drawn with `flag_p`, except the columns the temporal graph reads for
positions (AGVs: features 3, 4 = (y, x); pickers: 0, 1), which hold a walk
on the configuration's grid that moves at most one cell a step, folded back
at the walls. `positions` holds the same walk as float32 (x, y), edge-padded
by the horizon, as the trainer uploads its targets.
"""
from __future__ import annotations

import numpy as np
import torch

# Moves of the walk: stay, up, down, left, right as (dy, dx).
_MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def stream_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one named stream of a run (`path` names it), from
    the run's `--seed`; distinct paths give independent streams."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *[int(p) for p in path]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *path))


def _fold(v: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect integers into [0, size): a map that moves by at most the
    step it is given."""
    period = 2 * (size - 1)
    m = torch.remainder(v, period)
    return torch.where(m <= size - 1, m, period - m)


def make_corpus(episodes: int, steps: int, agents: int, features: int, num_agvs: int,
                grid_hw, horizon: int, flag_p: float, gen: torch.Generator, device,
                chunk: int = 40):
    """{'episodes': (E, T, N, D) uint8, 'positions': (E, T + horizon, N, 2)
    float32 (x, y)} on `device`, drawn from `gen` in chunks of episodes."""
    H, W = grid_hw
    eps = torch.empty(episodes, steps, agents, features, dtype=torch.uint8, device=device)
    pos = torch.empty(episodes, steps + horizon, agents, 2, dtype=torch.float32, device=device)
    moves = torch.tensor(_MOVES, dtype=torch.int64, device=device)
    is_agv = torch.arange(agents, device=device) < num_agvs
    for e0 in range(0, episodes, chunk):
        n = min(chunk, episodes - e0)
        block = eps[e0:e0 + n]
        block.copy_(torch.rand(block.shape, generator=gen, device=device) < flag_p)
        start = torch.stack([torch.randint(0, H, (n, 1, agents), generator=gen, device=device),
                             torch.randint(0, W, (n, 1, agents), generator=gen, device=device)], -1)
        step = moves[torch.randint(0, len(_MOVES), (n, steps - 1, agents), generator=gen,
                                   device=device)]
        walk = torch.cat([start, start + step.cumsum(1)], 1)  # (n, T, N, 2) (y, x)
        y, x = _fold(walk[..., 0], H), _fold(walk[..., 1], W)
        agv = is_agv[None, None, :]
        block[..., 3] = torch.where(agv, y, block[..., 3].long()).to(torch.uint8)
        block[..., 4] = torch.where(agv, x, block[..., 4].long()).to(torch.uint8)
        block[..., 0] = torch.where(agv, block[..., 0].long(), y).to(torch.uint8)
        block[..., 1] = torch.where(agv, block[..., 1].long(), x).to(torch.uint8)
        xy = torch.stack([x, y], -1).to(torch.float32)
        pos[e0:e0 + n, :steps] = xy
        pos[e0:e0 + n, steps:] = xy[:, -1:]
    return {"episodes": eps, "positions": pos}


def weight_specs(node_dim: int, hidden: int):
    """(name, shape, fan_in) of every GDE leaf in the program's state-dict
    names: three SAGE layers (lin_l with a bias, lin_r without) and the
    position decoder."""
    specs = []
    for i, (d_in, d_out) in enumerate(((node_dim, hidden), (hidden, hidden),
                                       (hidden, node_dim)), 1):
        base = f"func.conv{i}.DenseSAGEConv_0"
        specs += [(f"{base}.lin_l.weight", (d_out, d_in), d_in),
                  (f"{base}.lin_l.bias", (d_out,), d_in),
                  (f"{base}.lin_r.weight", (d_out, d_in), d_in)]
    specs += [("decoder.position_decoder.weight", (2, node_dim), node_dim),
              ("decoder.position_decoder.bias", (2,), node_dim)]
    return specs


def make_weights(node_dim: int, hidden: int, gen: torch.Generator, device):
    """{name: float32 tensor} on `device` from one normal draw: each kernel
    scaled by 1/sqrt(fan_in), each bias by a tenth of that."""
    specs = weight_specs(node_dim, hidden)
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, fan_in), size in zip(specs, sizes):
        scale = fan_in ** -0.5 * (0.1 if name.endswith("bias") else 1.0)
        out[name] = (flat[at:at + size] * scale).view(shape)
        at += size
    return out
