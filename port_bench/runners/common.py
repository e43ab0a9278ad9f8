"""Helpers the runners share: synchronisation, timing, sampling from the
seed, and the gaps the judges compare."""
from __future__ import annotations

import numpy as np
import torch

from port_bench import corpus

# Stream ids under a run's seed (corpus.stream_seed).
RESET, NOISE, CORPUS, WEIGHTS, FEED, SAMPLE, TRACE = range(1, 8)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


ENV_KEYS = ("shelf_rows", "shelf_columns", "column_height", "num_agvs", "num_pickers",
            "request_queue_size", "max_steps", "observation_type")


def check_env(config: dict, env_config) -> None:
    """The configuration file's sizes are those its env id runs."""
    bad = {k: (config[k], getattr(env_config, k)) for k in ENV_KEYS
           if config[k] != getattr(env_config, k)}
    if bad:
        raise ValueError(f"{config['env_id']}: the file's sizes differ from the env id's "
                         f"(file, env id): {bad}")


def sampler(seed: int) -> np.random.Generator:
    """The judge's draws of what to compare, from the seed."""
    return np.random.default_rng(corpus.stream_seed(seed, SAMPLE))


def leaf_gap(got, ref, keep=None) -> float:
    """The worst leaf's gap of norms: |‖got‖ - ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖ (over the kept leaves)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    g = [float(torch.linalg.vector_norm(got[i].double())) for i in idx]
    r = [float(torch.linalg.vector_norm(ref[i].double())) for i in idx]
    med = float(np.median(r))
    return max(abs(a - b) / max(b, med) for a, b in zip(g, r))
