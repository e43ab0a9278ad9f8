"""Plain reference of the GDE cells: the window cut, the spatio-temporal
graph as a dense adjacency, the graph ODE (three mean-aggregating SAGE
layers, euler over t = 0..horizon, a linear position decoder), the
horizon-weighted loss, the global-norm clip and AdamW.

Written from the model's description (reference train_gde.py's
GraphConverter, GraphODEFunc and GraphODE; optax's clip_by_global_norm and
adamw), in plain PyTorch on dense tensors: no edge list, no plan, no kernel.
It imports nothing of the program and takes its weights and windows from the
benchmark. Precision is the caller's: the judge runs it in float64, the
control in float32 with TF32 on.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def cut_windows(episodes, positions, pairs, window: int, horizon: int, true_len: int,
                dtype=torch.float32):
    """Windows ending at (episode, t) `pairs` (B, 2): the `window` frames
    from start = clip(t - window + 1, 0, T - window), frames after t zeroed
    (the warm-up), count = min(t + 1, window); targets the (x, y) positions
    at t+1 .. t+horizon and their weights (1 while within `true_len`).
    Returns (obs (B, W, N, D), count (B,), next_pos (B, Hz, N, 2),
    hweight (B, Hz))."""
    e, t = pairs[:, 0].long(), pairs[:, 1].long()
    T = episodes.shape[1]
    start = (t - window + 1).clamp(min=0, max=T - window)
    slot = start[:, None] + torch.arange(window, device=t.device)
    valid = (slot <= t[:, None])[..., None, None]
    obs = torch.where(valid, episodes[e[:, None], slot].to(dtype), 0.0)
    count = (t + 1).clamp(max=window)
    steps = t[:, None] + 1 + torch.arange(horizon, device=t.device)
    next_pos = positions[e[:, None], steps].to(dtype)
    hweight = (steps <= true_len - 1).to(dtype)
    return obs, count, next_pos, hweight


def adjacency(obs, count, num_agvs: int, threshold: float):
    """(B, W*N, W*N) [src, dst] adjacency of each window's graph, in obs's
    dtype: inside every valid frame an edge between two distinct agents
    closer than `threshold` ((y, x) at features 3, 4 for AGVs and 0, 1 for
    pickers), both ways; agent i of frame k to agent i of frame k+1 when
    frame k+1 is valid."""
    B, W, N, _ = obs.shape
    dev = obs.device
    agv = (torch.arange(N, device=dev) < num_agvs)[:, None]
    pos = torch.where(agv, obs[..., 3:5], obs[..., 0:2])
    d2 = ((pos[:, :, :, None, :] - pos[:, :, None, :, :]) ** 2).sum(-1)
    frame_valid = torch.arange(W, device=dev)[None, :] < count[:, None]
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    spatial = (d2 < threshold ** 2) & ~eye & frame_valid[:, :, None, None]
    adj = torch.zeros(B, W, N, W, N, dtype=obs.dtype, device=dev)
    for k in range(W):
        adj[:, k, :, k, :] = spatial[:, k].to(obs.dtype)
        if k + 1 < W:
            adj[:, k, :, k + 1, :] = (eye[None] & frame_valid[:, k + 1, None, None]).to(obs.dtype)
    return adj.reshape(B, W * N, W * N)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties up), as the
    tensor cores read a TF32 product's operands; gradients pass through
    unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x.detach())


def _mm(a, b, tf32: bool):
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


def sage(x, adj_t, inv_deg, w: Dict[str, torch.Tensor], prefix: str, tf32: bool = False):
    """SAGEConv(mean): lin_l(mean of in-neighbours) + lin_r(x), lin_l with a
    bias. adj_t: (B, S, S) [dst, src]; inv_deg: (B, S, 1), 0 where no
    in-neighbour. `tf32`: every product's operands rounded to TF32."""
    agg = _mm(adj_t, x, tf32) * inv_deg
    return (_mm(agg, w[prefix + ".lin_l.weight"].T, tf32) + w[prefix + ".lin_l.bias"]
            + _mm(x, w[prefix + ".lin_r.weight"].T, tf32))


def trajectories(w: Dict[str, torch.Tensor], obs, count, num_agvs: int, threshold: float,
                 horizon: int, tf32: bool = False):
    """(horizon+1, B, W, N, 2) decoded positions of every node at t = 0..
    horizon: euler steps of dt = 1 of dx/dt = SAGE3(relu(SAGE2(relu(
    SAGE1(x))))) from the window's features."""
    B, W, N, D = obs.shape
    adj_t = adjacency(obs, count, num_agvs, threshold).transpose(1, 2)
    deg = adj_t.sum(-1, keepdim=True)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
    y = obs.reshape(B, W * N, D)
    sols = [y]
    for _ in range(horizon):
        h = torch.relu(sage(y, adj_t, inv_deg, w, "func.conv1.DenseSAGEConv_0", tf32))
        h = torch.relu(sage(h, adj_t, inv_deg, w, "func.conv2.DenseSAGEConv_0", tf32))
        y = y + sage(h, adj_t, inv_deg, w, "func.conv3.DenseSAGEConv_0", tf32)
        sols.append(y)
    sol = torch.stack(sols)
    dec = (_mm(sol, w["decoder.position_decoder.weight"].T, tf32)
           + w["decoder.position_decoder.bias"])
    return dec.view(horizon + 1, B, W, N, 2)


def newest(traj, count):
    """(B, T, N, 2): each window's newest valid frame's agents."""
    B = traj.shape[1]
    slot = (count.long() - 1).clamp(min=0)
    return traj[:, torch.arange(B, device=traj.device), slot].transpose(0, 1)


def window_losses(w, obs, count, next_pos, hweight, horizon_weights: Sequence[float],
                  num_agvs: int, threshold: float, tf32: bool = False):
    """(B,) per-window loss: the MSE of the newest frame's predicted
    positions at t = 1..horizon against the targets, weighted by hweight
    times `horizon_weights` and normalised by those weights' sum."""
    horizon = next_pos.shape[1]
    cur = newest(trajectories(w, obs, count, num_agvs, threshold, horizon, tf32), count)[:, 1:]
    per = ((cur - next_pos) ** 2).mean(dim=(2, 3))  # (B, Hz)
    hw = hweight * torch.tensor(list(horizon_weights), dtype=obs.dtype, device=obs.device)
    return (per * hw).sum(1) / hw.sum(1).clamp(min=1.0)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below max_norm, else scaled to
    it."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if norm < max_norm:
        return list(grads)
    return [g / norm * max_norm for g in grads]


def adamw_step(params, grads, mu, nu, count: int, lr: float, weight_decay: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """optax.adamw after `count` - 1 earlier steps: new (params, mu, nu)."""
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        m_hat, v_hat = m / (1 - b1 ** count), v / (1 - b2 ** count)
        new_p.append(p - lr * (m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p))
        new_m.append(m)
        new_v.append(v)
    return new_p, new_m, new_v
