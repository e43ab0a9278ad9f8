"""The harness: finds a cell's configuration, traffic mix, runner and
per-layer readers by name, runs the cell once, and prints the result.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it, in the first
of the benchmark's `paths` that holds it:

  <path>/configs/<config>.json    the configuration's sizes (`file` names it)
  <path>/traffic/<traffic>.json   a traffic mix: its `runner` and parameters
  <path>/runners/<runner>.py      setup / window / trace / release / judge
  <path>/metrics/<metric>.py      read(m) -> a per-layer number, or None;
                                  where there is none, the reader of the
                                  name's first part (`device_idle.py` for
                                  `device_idle.serve`), shared by its cells

So a later cell, mix or metric is new files and new entries, and no file
here changes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "swarm_ode_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `swarm_ode_tpu_torch` is not
    `swarm_ode_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    root: pathlib.Path
    bench: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def _find(root: pathlib.Path, bench: Dict, kind: str, name: str, ext: str) -> pathlib.Path:
    for base in bench["paths"]:
        path = root / base / kind / f"{name}{ext}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind[:-1]} file {name}{ext} under {bench['paths']}")


def reader_path(root: pathlib.Path, bench: Dict, name: str) -> pathlib.Path:
    """metrics/<name>.py, or else metrics/<first part of name>.py."""
    try:
        return _find(root, bench, "metrics", name, ".py")
    except FileNotFoundError:
        return _find(root, bench, "metrics", name.split(".", 1)[0], ".py")


def load_module(path: pathlib.Path):
    """The module in `path`, loaded once under a name made from its
    folder, stem and path."""
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
    name = f"port_bench_{path.parent.name}_{path.stem}_{tag}".replace(".", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _reports(metric: Dict, cell: str, reported: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, listing none,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def load_cell(root, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files read."""
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(_find(root, bench, "traffic", wl["traffic"], ".json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, reported)]
    return Cell(root, bench, wl, config, traffic, e2e, per_layer)


@dataclasses.dataclass
class Context:
    """What a runner is given: the cell, the run's arguments, its device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    log: Callable[[str], None] = log

    @property
    def config(self) -> Dict:
        return self.cell.config

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic


@dataclasses.dataclass
class LayerInput:
    """What a per-layer reader is given."""

    slice: object  # tracing.Slice
    counters: Dict
    end_to_end: Dict[str, float]
    config: Dict
    traffic: Dict


def runner_of(cell: Cell):
    return load_module(_find(cell.root, cell.bench, "runners", cell.traffic["runner"], ".py"))


def read_layers(cell: Cell, inp: LayerInput) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        value = load_module(reader_path(cell.root, cell.bench, m["name"])).read(inp)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_device(chips: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}"
    return None


def run_cell(ctx: Context, t_start: float) -> Dict:
    """Set-up, the measured window, the traced slice (with --trace 1), the
    judge; returns the result's object (without the no-JAX check)."""
    import torch

    cell, drv = ctx.cell, runner_of(ctx.cell)
    on_card = ctx.device != "cpu"
    ctx.log(f"[{cell.name}] {time.perf_counter() - t_start:.3f} s from start to the runner")
    state = drv.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    ctx.log(f"[{cell.name}] set-up {setup_s:.3f} s")
    out = drv.window(ctx, state)
    e2e = dict(out["metrics"], setup_s=setup_s)
    ctx.log(f"[{cell.name}] window: " + ", ".join(f"{k} {v!r}" for k, v in e2e.items()))
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": int(cell.workload.get("chips", 1))}
    result = {"correct": None, "attempted": int(out["attempted"]), "failed": int(out["failed"])}
    if ctx.trace:
        sl, counters = drv.trace(ctx, state)
        layers = read_layers(cell, LayerInput(sl, counters, e2e, ctx.config, ctx.traffic))
        from port_bench import tracing

        result["metrics"] = layers
        device.update(busy_s=sl.busy_s, window_s=sl.window_s)
        ctx.log(f"[{cell.name}] traced: light pass busy {sl.busy_s!r} of {sl.window_s!r} s, "
                f"full pass busy {sl.full_busy_s!r} of {sl.full_window_s!r} s")
        result["breakdown"] = tracing.breakdown(sl)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": e2e[k], "unit": units[k]} for k in units if k in e2e}
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if on_card else 0
    result["device"] = device
    drv.release(state)
    checks = drv.judge(ctx, state)
    result["correct"] = all(v <= lim for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(args, t_start: float) -> int:
    os.environ.setdefault("USE_FLAX", "0")
    try:
        cell = load_cell(args.root, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        log(f"cannot load the cell: {exc}")
        return 2
    import torch

    t_import = time.perf_counter() - t_start
    err = check_device(int(cell.workload.get("chips", 1)))
    if err:
        log(f"no result: {err}")
        return 3
    log(f"[{cell.name}] import torch {t_import:.3f} s, CUDA found "
        f"{time.perf_counter() - t_start - t_import:.3f} s")

    torch.set_num_threads(4)
    ctx = Context(cell, args.seed, float(args.seconds), bool(args.trace))
    result = run_cell(ctx, t_start)
    found = forbidden_modules()
    if found:
        log(f"no result: modules of jax or the JAX package are loaded: {', '.join(found)}")
        return 4
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
