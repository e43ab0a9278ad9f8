"""Offline dataset generation: batched heuristic rollouts to HDF5.

Counterpart of `swarm_ode_tpu/data/collect.py` (parity: reference
scripts/collect_data.py:379-441, heuristic episodes logged step by step).
`collect_batch` runs B episodes at once on the device, the deterministic
dispatcher and the env step with the pre-step snapshot of every step
(`_capture`), and copies each chunk of steps to the host with one
`torch.stack(...).cpu()` per key; inside a chunk nothing reads back to the
host. `collect_data` writes those host arrays with `data/hdf5_logger.py`,
which needs h5py; `collect_batch` does not.

Seeds: JAX gives episode i the key PRNGKey(seed + i), so an episode depends
only on its own seed, whatever the batch. Here a batch's draws come from one
`torch.Generator`, seeded with the seed of the batch's first episode
(seed + the number of episodes written before it): the same seed and batch
give the same file, and a different batch gives other episodes. Each
episode's `seed` attribute is written as JAX writes it, seed + its index.

    python -m swarm_ode_tpu_torch.data.collect --env_ids <id> --seeds 0 \\
        --num_episodes 8 --batch 8 --out_dir datasets --device cuda
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env import observations, step as step_mod
from swarm_ode_tpu_torch.env.layout import Layout, build_layout
from swarm_ode_tpu_torch.env.state import EnvParams, EnvState, make_params, occupancy_grids
from swarm_ode_tpu_torch.policies import heuristic as H
from swarm_ode_tpu_torch.utils.metrics import pick_rate

INFO_KEYS = ("shelf_deliveries", "clashes", "stucks")


def _capture(params: EnvParams, state: EnvState, actions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Pre-step snapshot of B envs matching log_step_pre
    (collect_data.py:46-127), each value (B, ...).

    Dtypes are the smallest exact containers (the device->host copy is the
    datagen's bottleneck): observations are small integers and 0/1 flags,
    exact in float16 when coordinates are unnormalised; ids fit int16;
    bitmaps fit uint8. Readers upcast (TrajectoryDataset -> float32)."""
    grids = occupancy_grids(params, state)  # agv, picker, shelf, carried
    obs = observations.observe(params, state)
    if not params.normalised_coordinates:
        obs = obs.to(torch.float16)
    return {
        "actions": actions.to(torch.int16),
        "agent_positions": state.agent_xy.to(torch.int16),
        "agent_directions": state.agent_dir.to(torch.int8),
        "agent_busy": state.agent_busy,
        "agent_carrying_shelf": state.agent_carrying > 0,
        "agent_targets": state.agent_target.to(torch.int16),
        "grid_collision_layers": torch.stack(grids, dim=1).to(torch.int16),
        "request_queue_ids": state.request_queue.to(torch.int16),
        "shelf_request_info": observations.shelf_request_info(params, state).to(torch.uint8),
        "empty_shelf_info": observations.empty_shelf_info(params, state).to(torch.uint8),
        "observations": obs,
    }


def collect_batch(
    params: EnvParams,
    layout: Layout,
    B: int,
    steps: int,
    chunk: int = 100,
    generator: Optional[torch.Generator] = None,
    state: Optional[EnvState] = None,
    noise: Optional[Sequence[step_mod.StepNoise]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """B heuristic episodes of `steps` steps from a reset drawn from
    `generator` (or from `state`), the step's draws from `generator` (or
    `noise[t]` at step t).

    Returns (traj, stats): traj maps each logged key to a host array
    (B, steps, ...), the `_capture` snapshot before each step plus its
    `rewards` and `info_shelf_deliveries` / `info_clashes` / `info_stucks`;
    stats holds per-episode (B,) host arrays `deliveries`, `clashes`,
    `stucks`, `returns` and `replan_overflow` (summed on the device, where
    it is not logged). Chunks of `chunk` steps are copied off the device
    one key at a time; the last chunk runs only the steps left (JAX runs it
    whole and cuts its arrays to `steps`: the arrays are the same)."""
    policy = H.make_policy(params, layout)
    es = state if state is not None else step_mod.reset(params, B, generator)
    h = H.init_state(params, B)
    overflow = torch.zeros(B, dtype=torch.int32, device=params.device)
    host: Dict[str, list] = {}
    for c0 in range(0, steps, chunk):
        snaps = []
        for t in range(c0, min(c0 + chunk, steps)):
            actions, h = policy(params, es, h)
            snap = _capture(params, es, actions)
            es, rewards, _, info = step_mod.step(
                params, es, actions, generator=generator,
                noise=None if noise is None else noise[t],
            )
            snap["rewards"] = rewards
            for k in INFO_KEYS:
                snap[f"info_{k}"] = info[k]
            overflow += info["replan_overflow"]
            snaps.append(snap)
        for k in snaps[0]:
            host.setdefault(k, []).append(torch.stack([s[k] for s in snaps], dim=1).cpu())
    traj = {k: torch.cat(v, dim=1).numpy() for k, v in host.items()}
    stats = {
        "deliveries": traj["info_shelf_deliveries"].sum(axis=1),
        "clashes": traj["info_clashes"].sum(axis=1),
        "stucks": traj["info_stucks"].sum(axis=1),
        "returns": traj["rewards"].sum(axis=(1, 2)),
        "replan_overflow": overflow.cpu().numpy(),
    }
    return traj, stats


def collect_data(
    env_id: str,
    num_episodes: int,
    seed: int,
    out_path: Optional[str] = None,
    batch: int = 8,
    chunk: int = 100,
    verbose: bool = True,
    schema: str = "columnar",
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> Dict:
    """Generate `num_episodes` heuristic episodes into HDF5, `batch` at a
    time on `device`.

    File naming matches the reference (collect_data.py:381):
    warehouse_data_{env_id}_seed{seed}.h5 unless out_path is given. Each
    batch draws from a generator seeded with its first episode's seed, or
    from `generator` when one is given."""
    from swarm_ode_tpu_torch.data.hdf5_logger import HDF5Logger

    cfg = EnvConfig.from_env_id(env_id)
    lay = build_layout(cfg)
    params = make_params(cfg, lay, device)
    steps = cfg.max_steps or 500
    out_path = out_path or f"warehouse_data_{env_id}_seed{seed}.h5"

    logger = HDF5Logger(out_path, schema=schema)
    stats = {"episodes": 0, "deliveries": [], "pick_rates": []}
    ep_done = 0
    t_start = time.time()
    while ep_done < num_episodes:
        B = min(batch, num_episodes - ep_done)
        seeds = np.arange(seed + ep_done, seed + ep_done + B)
        gen = generator or torch.Generator(device=params.device).manual_seed(int(seeds[0]))
        traj, _ = collect_batch(params, lay, B, steps, chunk, gen)
        for b in range(B):
            logger.start_episode(ep_done + b, int(seeds[b]), params, lay.rack_locations_xyg)
            if schema == "columnar":
                # The rollout is already stacked (T, ...): write episode
                # slices directly, no per-step loop.
                logger.write_columnar_episode(
                    logger._episode, {k: v[b] for k, v in traj.items()}
                )
                summary = logger._episode.create_group("summary")
                summary.create_dataset(
                    "episode_returns", data=traj["rewards"][b].sum(axis=0)
                )
                summary.attrs["episode_length"] = steps
                logger._episode = None
            else:
                for t in range(steps):
                    logger.log_step({k: v[b, t] for k, v in traj.items()})
                logger.end_episode()
            deliveries = int(traj["info_shelf_deliveries"][b].sum())
            pr = pick_rate(deliveries, steps)
            stats["deliveries"].append(deliveries)
            stats["pick_rates"].append(pr)
            if verbose:
                ret = float(traj["rewards"][b].sum())
                print(
                    f"Env: {env_id} | Seed: {seeds[b]} | Episode {ep_done + b}: "
                    f"| [Overall Pick Rate={pr:.2f}]"
                    f"| [Global return={ret:.2f}]"
                    f"| [Total shelf deliveries={deliveries:.2f}]"
                    f"| [Total clashes={int(traj['info_clashes'][b].sum()):.2f}]"
                    f"| [Total stuck={int(traj['info_stucks'][b].sum()):.2f}]"
                )
        ep_done += B
    logger.close()
    stats["episodes"] = ep_done
    stats["wall_time"] = time.time() - t_start
    if verbose:
        print(
            f"Collected {ep_done} episodes in {stats['wall_time']:.1f}s -> {out_path}"
        )
    return stats


# The reference's default sweep (scripts/collect_data.py): 5 env configs x 5
# base seeds x 200 episodes.
DEFAULT_ENVS = [
    "tarware-tiny-3agvs-2pickers-partialobs-v1",
    "tarware-small-6agvs-3pickers-partialobs-v1",
    "tarware-medium-10agvs-5pickers-partialobs-v1",
    "tarware-medium-19agvs-9pickers-partialobs-v1",
    "tarware-large-15agvs-8pickers-partialobs-v1",
]
DEFAULT_SEEDS = [0, 1000, 2000, 3000, 4000]


def _parser():
    from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

    p = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter,
                       description="Heuristic expert datasets (HDF5) from the port.")
    p.add_argument("--env_ids", nargs="*", default=DEFAULT_ENVS)
    p.add_argument("--seeds", nargs="*", type=int, default=DEFAULT_SEEDS)
    p.add_argument("--num_episodes", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out_dir", default=".")
    p.add_argument(
        "--schema", default="columnar", choices=["columnar", "reference"],
        help="columnar: stacked per-episode datasets (~50x smaller files); "
        "reference: the upstream group-per-step layout for interop",
    )
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def main(argv=None) -> None:
    from pathlib import Path

    args = _parser().parse_args(argv)
    Path(args.out_dir).mkdir(parents=True, exist_ok=True)
    for env_id in args.env_ids:
        for seed in args.seeds:
            out = str(Path(args.out_dir) / f"warehouse_data_{env_id}_seed{seed}.h5")
            if Path(out).exists():
                import h5py

                with h5py.File(out, "r") as f:
                    n = sum(1 for k in f.keys() if k.startswith("episode_"))
                if n >= args.num_episodes:
                    print(f"Skipping {out} (complete: {n} episodes)")
                    continue
            print(f"Starting data collection for {env_id} with seed {seed}")
            collect_data(env_id, num_episodes=args.num_episodes, seed=seed, out_path=out,
                         batch=args.batch, schema=args.schema, device=args.device)
            print(f"Completed data collection for {env_id} with seed {seed}")


if __name__ == "__main__":
    main()
