"""Trajectory-prediction evaluation metrics and dataset analysis.

Counterpart of `swarm_ode_tpu/analysis.py` (result_analysis.ipynb cells
1-4): the metric suite is a copy of its numpy code (position errors,
direction error, success rates, multi-step error, collision prediction,
Hausdorff and DTW shape metrics, spatial density, trajectory statistics),
with the same names, keys and float types. `evaluate_gde` and
`evaluate_baseline` score a trained trajectory model on the card unless
the caller passes device="cpu".

The evaluator uploads the episodes that the windows come from, and their
positions, to the device once, cuts each batch of windows there with the
trainer's `train_gde._extract_windows` (TrajectoryDataset.window's
semantics), keeps the predictions on the device and copies them to the
host once; the metrics are then computed on the host in JAX's order. The
GDE predicts through `serving.make_gde_fn(horizon=1)`, so every batch plans
its edges once and aggregates through K4. Unlike JAX, no tail batch is
padded: a short last batch is one more batch of its own size.

As in JAX, `_evaluate_predictor` scores collisions with
`collision_prediction_metrics(pred[None], target[None])` on (windows, N, 2):
with that 4-D input the pairs are one agent slot across two windows, not
two agents of one window, and the distance array grows as windows^2 x N.

    python -m swarm_ode_tpu_torch.analysis results --files data/*.h5 --checkpoint_dir ckpt
    python -m swarm_ode_tpu_torch.analysis dataset --files data/*.h5 [--heatmap_out d.png]
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset, extract_positions_np
from swarm_ode_tpu_torch.serving import make_gde_fn
from swarm_ode_tpu_torch.train.train_gde import _extract_windows


def position_error_metrics(
    pred: np.ndarray, target: np.ndarray
) -> Dict[str, float]:
    """Mean / median / max / std Euclidean position error.

    pred, target: (..., 2) arrays of (x, y)."""
    err = np.linalg.norm(
        np.asarray(pred) - np.asarray(target), axis=-1
    ).reshape(-1)
    return {
        "mean_error": float(err.mean()),
        "median_error": float(np.median(err)),
        "max_error": float(err.max()),
        "std_error": float(err.std()),
        "rmse": float(np.sqrt((err**2).mean())),
    }


def direction_error_metrics(
    pred: np.ndarray, target: np.ndarray, prev: np.ndarray
) -> Dict[str, float]:
    """Angle between predicted and true movement vectors (degrees), over
    steps where the agent actually moved."""
    pv = np.asarray(pred) - np.asarray(prev)
    tv = np.asarray(target) - np.asarray(prev)
    pn = np.linalg.norm(pv, axis=-1)
    tn = np.linalg.norm(tv, axis=-1)
    moved = (pn > 1e-6) & (tn > 1e-6)
    if not moved.any():
        return {"mean_angle_error_deg": 0.0, "median_angle_error_deg": 0.0}
    cos = np.sum(pv * tv, axis=-1) / np.maximum(pn * tn, 1e-9)
    ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))[moved]
    return {
        "mean_angle_error_deg": float(ang.mean()),
        "median_angle_error_deg": float(np.median(ang)),
    }


def success_rates(
    pred: np.ndarray,
    target: np.ndarray,
    thresholds: Sequence[float] = (0.5, 1.0, 1.5, 2.0),
) -> Dict[str, float]:
    """Fraction of predictions within `thr` cells of the target
    (result_analysis.ipynb thresholds {0.5, 1, 1.5, 2})."""
    err = np.linalg.norm(
        np.asarray(pred) - np.asarray(target), axis=-1
    ).reshape(-1)
    return {
        f"success_rate@{t}": float((err <= t).mean()) for t in thresholds
    }


def multi_step_prediction_error(
    predict_fn,
    obs_seq: np.ndarray,
    positions: np.ndarray,
    horizon: int,
    seq_len: int,
) -> List[float]:
    """Autoregressive multi-step error: feed predictions back as positions.

    predict_fn(window_obs (W, N, D)) -> (N, 2) predicted next positions.
    obs_seq: (T, N, D); positions: (T, N, 2). Returns mean error per
    horizon step (result_analysis.ipynb `multi_step_prediction_accuracy`).
    Note: only the position features in the obs are rolled forward; the
    rest of the observation is held at its last real value, matching the
    notebook's simplification.
    """
    T = obs_seq.shape[0]
    start = seq_len
    errors = [[] for _ in range(horizon)]
    for t0 in range(start, T - horizon):
        window = obs_seq[t0 - seq_len : t0].copy()
        for h in range(horizon):
            pred = np.asarray(predict_fn(window))
            true = positions[t0 + h]
            errors[h].append(
                np.linalg.norm(pred - true, axis=-1).mean()
            )
            nxt = obs_seq[t0 + h].copy()
            window = np.concatenate([window[1:], nxt[None]], axis=0)
    return [float(np.mean(e)) for e in errors]


def collision_prediction_metrics(
    pred: np.ndarray, target: np.ndarray, threshold: float = 1.5
) -> Dict[str, float]:
    """Agent-pair proximity (< threshold cells) prediction quality
    (result_analysis.ipynb `analyze_collision_prediction`).

    pred, target: (T, N, 2)."""
    def pair_close(pos):
        d = np.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], axis=-1)
        iu = np.triu_indices(pos.shape[1], k=1)
        return d[:, iu[0], iu[1]] < threshold

    p = pair_close(np.asarray(pred)).reshape(-1)
    t = pair_close(np.asarray(target)).reshape(-1)
    tp = float((p & t).sum())
    fp = float((p & ~t).sum())
    fn = float((~p & t).sum())
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "collision_precision": precision,
        "collision_recall": recall,
        "collision_f1": f1,
        "collision_accuracy": float((p == t).mean()),
    }


def hausdorff_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric Hausdorff distance between two trajectories (T, 2)
    (result_analysis.ipynb cell 1 imports scipy's directed_hausdorff;
    computed directly here — max over both directed distances)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)  # (Ta, Tb)
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Dynamic-time-warping distance between two trajectories (T, 2)
    (result_analysis.ipynb cell 1 imports fastdtw): classic O(Ta*Tb) DP
    with Euclidean point cost."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    Ta, Tb = d.shape
    acc = np.full((Ta + 1, Tb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, Ta + 1):
        # acc[i, j] = d + min(acc[i-1, j], acc[i-1, j-1], acc[i, j-1]);
        # the in-row dependency resolves with a scan over j.
        prev = np.minimum(acc[i - 1, 1:], acc[i - 1, :-1])
        for j in range(1, Tb + 1):
            acc[i, j] = d[i - 1, j - 1] + min(prev[j - 1], acc[i, j - 1])
    return float(acc[Ta, Tb])


def trajectory_shape_metrics(
    pred: np.ndarray, target: np.ndarray
) -> Dict[str, float]:
    """Per-agent Hausdorff/DTW between predicted and true trajectories,
    averaged over agents. pred, target: (T, N, 2)."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    hs, ds = [], []
    for n in range(pred.shape[1]):
        hs.append(hausdorff_distance(pred[:, n], target[:, n]))
        ds.append(dtw_distance(pred[:, n], target[:, n]))
    return {
        "hausdorff_mean": float(np.mean(hs)),
        "hausdorff_max": float(np.max(hs)),
        "dtw_mean": float(np.mean(ds)),
        "dtw_max": float(np.max(ds)),
    }


def spatial_density(
    positions: np.ndarray, grid_size, normalize: bool = True
) -> np.ndarray:
    """(H, W) visit-count heatmap over logged agent positions
    (analyze_dataset.ipynb). positions: (..., 2) as (x, y)."""
    H, W = grid_size
    pos = np.asarray(positions).reshape(-1, 2)
    x = np.clip(pos[:, 0].astype(int), 0, W - 1)
    y = np.clip(pos[:, 1].astype(int), 0, H - 1)
    density = np.zeros((H, W))
    np.add.at(density, (y, x), 1.0)
    if normalize and density.max() > 0:
        density /= density.max()
    return density


def trajectory_statistics(positions: np.ndarray) -> Dict[str, float]:
    """Per-agent movement stats over an episode. positions: (T, N, 2)."""
    pos = np.asarray(positions)
    deltas = np.linalg.norm(np.diff(pos, axis=0), axis=-1)  # (T-1, N)
    return {
        "total_distance_mean": float(deltas.sum(axis=0).mean()),
        "step_distance_mean": float(deltas.mean()),
        "fraction_moving": float((deltas > 1e-6).mean()),
    }


def predict_windows(predict: Callable, dataset: TrajectoryDataset, indices=None,
                    batch_size: int = 64, device="cuda", with_pos: bool = False):
    """(predictions, targets), numpy (windows, N, 2): `predict(batch) -> (B,
    N, 2)` over the dataset's windows `indices` (default all), in batches of
    `batch_size` cut on `device` ({'obs', 'count', 'next_pos'}, and 'pos',
    the windows' positions, with `with_pos`). Only the episodes the windows
    come from go to the device, once, zero-padded to one length (a window
    reads no frame past its own step + 1); the predictions and targets come
    back in one copy each."""
    index = np.asarray(dataset._index, np.int64).reshape(-1, 2)[
        np.asarray(list(indices if indices is not None else range(len(dataset))), np.int64)]
    if not len(index):
        raise ValueError("no windows to evaluate")
    used, slot = np.unique(index[:, 0], return_inverse=True)
    eps = [dataset.episodes[e] for e in used]
    T = max(max(ep.shape[0] for ep in eps), dataset.seq_len)
    episodes = np.zeros((len(eps), T) + eps[0].shape[1:], np.result_type(*eps))
    positions = np.zeros((len(eps), T, eps[0].shape[1], 2), np.float32)
    for i, ep in enumerate(eps):
        episodes[i, : ep.shape[0]] = ep
        positions[i, : ep.shape[0]] = extract_positions_np(np.asarray(ep, np.float32),
                                                           dataset.num_agvs)
    episodes_dev = torch.from_numpy(episodes).to(device)
    positions_dev = torch.from_numpy(positions).to(device)
    pairs = torch.from_numpy(np.stack([slot.reshape(-1), index[:, 1]], axis=1)).to(device)
    keys = ("obs", "count", "next_pos", "pos")
    preds, targets = [], []
    with torch.no_grad():
        for i in range(0, pairs.shape[0], batch_size):
            p = pairs[i: i + batch_size]
            batch = dict(zip(keys, _extract_windows(episodes_dev, positions_dev,
                                                    dataset.seq_len, p[:, 0], p[:, 1],
                                                    with_pos=with_pos)))
            preds.append(predict(batch))
            targets.append(batch["next_pos"])
    return torch.cat(preds).cpu().numpy(), torch.cat(targets).cpu().numpy()


def prediction_metrics(pred: np.ndarray, target: np.ndarray) -> Dict[str, float]:
    """The evaluators' metric suite over (windows, N, 2) predictions and
    targets, in JAX's order: position errors, success rates, collision
    metrics of the (1, windows, N, 2) call (module docstring)."""
    out = position_error_metrics(pred, target)
    out.update(success_rates(pred, target))
    out.update(collision_prediction_metrics(pred[None], target[None]))
    return out


def _evaluate_predictor(predict, dataset, indices=None, batch_size: int = 64, device="cuda",
                        with_pos: bool = False) -> Dict[str, float]:
    """Shared evaluation loop: `predict(batch) -> (B, N, 2)` over the
    dataset's windows on `device` (predict_windows), then position errors,
    success rates and collision metrics (result_analysis.ipynb cell 3)."""
    return prediction_metrics(*predict_windows(predict, dataset, indices, batch_size, device,
                                               with_pos))


def _model_on(model: torch.nn.Module, params, device) -> torch.nn.Module:
    """A copy of `model` on `device`, with `params` (a state dict) loaded
    when given; the caller's model is left as it is."""
    model = copy.deepcopy(model).to(device)
    if params is not None:
        model.load_state_dict(params)
    return model


def gde_predictor(model, params, num_agvs: int, device="cuda") -> Callable:
    """predict(batch) -> (B, N, 2) of the GDE (a copy of `model` with
    `params`, on `device`): the t = 1 positions (one Euler step over
    t_span = [0, 1]) of the newest valid frame's agents, on graphs whose
    first `num_agvs` agents are AGVs, through serving.make_gde_fn."""
    server = make_gde_fn(_model_on(model, params, device), horizon=1, num_agvs=num_agvs)
    return lambda b: server(b["obs"], b["count"])[:, 1]


def baseline_predictor(model, params, position_only: bool = False, device="cuda") -> Callable:
    """predict(batch) -> (B, N, 2) of a trajectory baseline (a copy of
    `model` with `params`, on `device`): model(obs), or model(pos) of the
    windows' positions with `position_only`."""
    net = _model_on(model, params, device)
    key = "pos" if position_only else "obs"
    return lambda b: net(b[key])


def evaluate_gde(
    model,
    params,
    dataset,
    indices: Optional[Sequence[int]] = None,
    batch_size: int = 64,
    device="cuda",
) -> Dict[str, float]:
    """Full evaluation of a trained GraphODE over a dataset on `device`:
    position errors, success rates, collision metrics
    (result_analysis.ipynb cell 3). `params`: the model's state dict, or
    None for the model's own; the graphs take the dataset's `num_agvs`, as
    JAX's do. K4 aggregates every batch on the card."""
    predict = gde_predictor(model, params, dataset.num_agvs, device)
    return _evaluate_predictor(predict, dataset, indices, batch_size, device)


def evaluate_baseline(
    model,
    params,
    dataset,
    position_only: bool = False,
    indices: Optional[Sequence[int]] = None,
    batch_size: int = 64,
    device="cuda",
) -> Dict[str, float]:
    """Same metric suite as evaluate_gde for the GRU/LSTM/PositionOnly
    trajectory baselines (reference train_baselines.py:338-531), so the
    model-comparison table is apples-to-apples (baseline_predictor)."""
    predict = baseline_predictor(model, params, position_only, device)
    return _evaluate_predictor(predict, dataset, indices, batch_size, device,
                               with_pos=position_only)


def _results(args) -> None:
    import json
    import sys

    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager

    ds = TrajectoryDataset.from_h5(args.files, seq_len=args.seq_len,
                                   max_episodes=args.max_episodes)
    model = GraphODE(node_dim=ds.obs_dim, num_agvs=ds.num_agvs, num_pickers=ds.num_pickers,
                     hidden_dim=args.hidden_dim)
    restored = CheckpointManager(args.checkpoint_dir).restore(
        {"params": dict(model.state_dict())}, partial=True)
    if restored is None:
        sys.exit("No checkpoint found")
    indices = range(min(len(ds), args.max_windows))
    metrics = evaluate_gde(model, restored["params"], ds, indices, device=args.device)
    print(json.dumps({k: round(v, 5) for k, v in metrics.items()}, indent=2))


def _dataset(args) -> None:
    import json

    ds = TrajectoryDataset.from_h5(args.files, max_episodes=args.max_episodes)
    all_pos = [extract_positions_np(ep, ds.num_agvs) for ep in ds.episodes]
    stats = {}
    per_ep = [trajectory_statistics(p_) for p_ in all_pos]
    for k in per_ep[0]:
        stats[k] = float(np.mean([s[k] for s in per_ep]))
    stats["episodes"] = len(ds.episodes)
    stats["steps_per_episode"] = int(ds.episodes[0].shape[0])
    print(json.dumps(stats, indent=2))

    if args.heatmap_out:
        H = int(max(p_[..., 1].max() for p_ in all_pos)) + 2
        W = int(max(p_[..., 0].max() for p_ in all_pos)) + 2
        density = spatial_density(
            np.concatenate([p_.reshape(-1, 2) for p_ in all_pos]), (H, W)
        )
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imshow(density, cmap="viridis")
        plt.colorbar(label="visit density")
        plt.title("agent spatial density")
        plt.savefig(args.heatmap_out, dpi=120, bbox_inches="tight")
        print(f"saved {args.heatmap_out}")


def main(argv=None) -> None:
    """The evaluation CLI. `results`: scripts/analyze_results.py's flags; a
    GDE checkpoint of the port's train_gde scored over a dataset's first
    `max_windows` windows on `--device` (the card by default), the metrics
    printed as JSON (5 places). `dataset`: scripts/analyze_dataset.py's;
    trajectory statistics over the logged episodes, and a density heatmap
    (matplotlib, imported only then) with --heatmap_out."""
    import argparse

    fmt = argparse.ArgumentDefaultsHelpFormatter
    p = argparse.ArgumentParser(description=main.__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("results", formatter_class=fmt, help="score a trained GDE checkpoint")
    r.add_argument("--files", nargs="+", required=True, help="h5 dataset paths")
    r.add_argument("--checkpoint_dir", required=True)
    r.add_argument("--seq_len", type=int, default=5)
    r.add_argument("--hidden_dim", type=int, default=64)
    r.add_argument("--max_episodes", type=int, default=None)
    r.add_argument("--max_windows", type=int, default=2000)
    r.add_argument("--device", default="cuda")
    d = sub.add_parser("dataset", formatter_class=fmt, help="statistics of logged episodes")
    d.add_argument("--files", nargs="+", required=True)
    d.add_argument("--max_episodes", type=int, default=None)
    d.add_argument("--heatmap_out", default=None, help="save density heatmap PNG")
    args = p.parse_args(argv)
    (_results if args.command == "results" else _dataset)(args)


if __name__ == "__main__":
    main()
