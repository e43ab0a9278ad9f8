"""A benchmark root in a temporary directory with tiny traffic mixes, so
that the harness and its runners run on the CPU in seconds."""
from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
PB = REPO / "port_bench"

# Tiny versions of each mix: the same parameters at sizes the CPU holds.
TINY = {
    "rollout": {"batch": 16, "steps": 20, "sample_envs": 6, "trace_steps": 2, "trace_from": 3,
                "low_envs": 1, "sample_low_envs": 1},
    "gde_train": {"episodes": 4, "episode_steps": 30, "batch": 16, "reference_block": 8,
                  "trace_steps": 2},
    "gde_serve": {"episodes": 3, "episode_steps": 30, "batch": 8, "max_batches": 50,
                  "sample_batches": 3, "trace_batches": 2},
}


def traffic(name: str, **changes) -> dict:
    mix = json.loads((PB / "traffic" / f"{name}.json").read_text())
    mix.update(TINY[name])
    mix.update(changes)
    return mix


def tiny_root(tmp: pathlib.Path, **changes) -> pathlib.Path:
    """tmp holding BENCHMARK.json, the configurations, runners and readers,
    and tiny traffic mixes (each mix's `changes` given as {mix: {key: value}})."""
    (tmp / "port_bench" / "traffic").mkdir(parents=True)
    for kind in ("configs", "runners", "metrics"):
        shutil.copytree(PB / kind, tmp / "port_bench" / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name in TINY:
        mix = traffic(name, **changes.get(name, {}))
        (tmp / "port_bench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    return tmp


def run(root: pathlib.Path, workload: str, seed: int = 2**31 + 7, trace: bool = False,
        seconds: float = 0.5) -> dict:
    """One run of a cell on the CPU, as the harness runs it on the card
    (set-up, window, traced slice, judge), without the look for a card."""
    import time

    from port_bench import harness

    cell = harness.load_cell(root, workload)
    ctx = harness.Context(cell, seed, seconds, trace, device="cpu", log=lambda msg: None)
    return harness.run_cell(ctx, time.perf_counter())
