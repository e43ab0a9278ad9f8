"""HDF5 episode logging with the reference's on-disk schema.

Schema parity (reference collect_data.py:13-177): files hold
`episode_{id:06d}/metadata` (attrs: seed, num_agvs, num_pickers, grid_size;
dataset rack_locations [x, y, group]), `steps/step_{t:06d}/<datasets>`
(actions, agent_positions, agent_directions, agent_busy,
agent_carrying_shelf, agent_targets, grid_collision_layers,
request_queue_ids, shelf_request_info, empty_shelf_info, observations,
rewards; info_* attrs), and `summary` (episode_returns, episode_length).
gzip level 1 like the reference (collect_data.py:157-160).

A copy of `swarm_ode_tpu/data/hdf5_logger.py` (numpy and h5py), kept by
the port so that it imports nothing of the JAX package and writes the same
files. The datagen path hands it host arrays (B, T, ...) that
`data/collect.collect_batch` copied off the device chunk by chunk. h5py is
imported when a logger is made, never at import.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from swarm_ode_tpu_torch.env.state import EnvParams


class HDF5Logger:
    """Episode logger with two on-disk schemas:

    - ``reference``: group-per-step, dataset-per-field — byte-compatible
      with the reference's layout (collect_data.py:137-170) for interop.
      Intrinsically bloated: ~13 HDF5 objects x 500 steps x ~1.5 KB object
      overhead ≈ 10 MB/episode of pure metadata.
    - ``columnar`` (default for our datagen): one stacked (T, ...) dataset
      per field per episode — ~50x smaller files, ~10x faster writes, and
      exactly the layout the device-resident TrajectoryDataset wants.
      Marked with episode attr ``schema='columnar_v1'``; readers accept
      both.
    """

    def __init__(self, filepath: str, schema: str = "reference"):
        try:
            import h5py
        except ImportError as e:  # pragma: no cover
            raise ImportError("h5py is required for HDF5 logging") from e
        assert schema in ("reference", "columnar"), schema
        self.filepath = filepath
        self.schema = schema
        self.file = h5py.File(filepath, "w")
        self._episode = None
        self._steps = []

    # ---- reference-compatible per-step API (collect_data.py:20-170) ----
    def start_episode(self, episode_id: int, seed: int, params: EnvParams,
                      rack_locations: np.ndarray):
        name = f"episode_{episode_id:06d}"
        if name in self.file:
            del self.file[name]
        ep = self.file.create_group(name)
        meta = ep.create_group("metadata")
        meta.attrs["seed"] = seed
        meta.attrs["num_agvs"] = params.num_agvs
        meta.attrs["num_pickers"] = params.num_pickers
        meta.attrs["grid_size"] = (params.grid_h, params.grid_w)
        meta.create_dataset("rack_locations", data=np.asarray(rack_locations))
        self._episode = ep
        self._steps = []

    def log_step(self, step_data: Dict[str, np.ndarray]):
        self._steps.append(step_data)

    def end_episode(self):
        if self._episode is None or not self._steps:
            return
        if self.schema == "columnar":
            stacked = {
                k: np.stack([sd[k] for sd in self._steps])
                for k in self._steps[0]
            }
            self.write_columnar_episode(self._episode, stacked)
        else:
            steps = self._episode.create_group("steps")
            for t, sd in enumerate(self._steps):
                g = steps.create_group(f"step_{t:06d}")
                for key, value in sd.items():
                    if key.startswith("info_"):
                        g.attrs[key] = value
                    else:
                        g.create_dataset(
                            key, data=np.asarray(value), compression="gzip",
                            compression_opts=1,
                        )
        summary = self._episode.create_group("summary")
        rewards = np.stack([sd["rewards"] for sd in self._steps])
        summary.create_dataset("episode_returns", data=rewards.sum(axis=0))
        summary.attrs["episode_length"] = len(self._steps)
        self._episode = None
        self._steps = []

    @staticmethod
    def write_columnar_episode(ep_group, stacked: Dict[str, np.ndarray]):
        """Write pre-stacked (T, ...) fields as one dataset each."""
        ep_group.attrs["schema"] = "columnar_v1"
        steps = ep_group.create_group("steps")
        for key, value in stacked.items():
            steps.create_dataset(
                key, data=np.asarray(value), compression="gzip",
                compression_opts=1,
            )

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_batch_trajectories(
    filepath: str,
    params: EnvParams,
    rack_locations: np.ndarray,
    traj: Dict[str, np.ndarray],
    seeds: np.ndarray,
    episode_offset: int = 0,
) -> int:
    """Write a batched rollout to HDF5 in the reference schema.

    traj values are host numpy arrays shaped (B, T, ...) — one episode per
    batch lane (the vmapped datagen path). Returns number of episodes
    written.
    """
    logger = HDF5Logger(filepath) if isinstance(filepath, str) else filepath
    B = traj["rewards"].shape[0]
    T = traj["rewards"].shape[1]
    for b in range(B):
        logger.start_episode(episode_offset + b, int(seeds[b]), params,
                             rack_locations)
        for t in range(T):
            sd = {k: v[b, t] for k, v in traj.items()}
            logger.log_step(sd)
        logger.end_episode()
    if isinstance(filepath, str):
        logger.close()
    return B
