"""Episode statistics with the reference's metric names and conventions.

`info_statistics` mirrors the accumulator duplicated across reference
scripts (run_heuristic.py:30-45, collect_data.py:362-377); `pick_rate`
keeps the 5-seconds-per-step convention (run_heuristic.py:56).
A copy of `swarm_ode_tpu/utils/metrics.py` (numpy only), kept by the port so
that it imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from swarm_ode_tpu_torch.definitions import SECONDS_PER_STEP


def pick_rate(total_deliveries: float, episode_length: int) -> float:
    """Order-lines per hour (reference run_heuristic.py:56)."""
    return total_deliveries * 3600.0 / (SECONDS_PER_STEP * episode_length)


def info_statistics(
    infos: List[Dict], global_episode_return: float, episode_returns: np.ndarray
) -> Dict:
    """Accumulate per-step infos into the reference's last_info summary."""
    total_deliveries = 0
    total_clashes = 0
    total_stuck = 0
    for info in infos:
        total_deliveries += int(info["shelf_deliveries"])
        total_clashes += int(info["clashes"])
        total_stuck += int(info["stucks"])
        info["total_deliveries"] = total_deliveries
        info["total_clashes"] = total_clashes
        info["total_stuck"] = total_stuck
    last_info = dict(infos[-1])
    last_info["episode_length"] = len(infos)
    last_info["global_episode_return"] = global_episode_return
    last_info["episode_returns"] = episode_returns
    last_info["overall_pick_rate"] = pick_rate(total_deliveries, len(infos))
    return last_info


def summarize_traj(rewards: np.ndarray, info: Dict[str, np.ndarray]) -> Dict:
    """Summarize a scanned trajectory (arrays with leading time axis)."""
    T = rewards.shape[0]
    deliveries = int(np.asarray(info["shelf_deliveries"]).sum())
    out = {
        "episode_length": T,
        "total_deliveries": deliveries,
        "total_clashes": int(np.asarray(info["clashes"]).sum()),
        "total_stuck": int(np.asarray(info["stucks"]).sum()),
        "global_episode_return": float(np.asarray(rewards).sum()),
        "episode_returns": np.asarray(rewards).sum(axis=0),
        "overall_pick_rate": pick_rate(deliveries, T),
        "agvs_distance_travelled": int(
            np.asarray(info["agvs_distance_travelled"]).sum()
        ),
        "pickers_distance_travelled": int(
            np.asarray(info["pickers_distance_travelled"]).sum()
        ),
    }
    return out
