"""Datasets over logged HDF5 rollouts.

A copy of `swarm_ode_tpu/data/dataset.py` (numpy, no JAX), kept by the port
so that it imports nothing of the JAX package. h5py is imported only where
an HDF5 file is decoded: importing this module, building a dataset from
arrays in memory, and reading a file's `.obscache.npy` sidecar need no h5py.
The sidecars have the JAX copy's format and names, so either package reads
what the other wrote.

Parity targets:
  * WarehouseDataset (reference train_gde.py:278-375): per-step
    temporal-window graphs paired with next-step agent positions.
  * SequenceDataset (reference train_baselines.py:13-125): sliding windows
    of observations/positions with next-position targets.

The reference materializes one PyG graph per step on the host. Here the
dataset holds raw per-episode observation arrays and yields *index-based
windows*; the temporal graph is built on the device inside the training
step (swarm_ode_tpu_torch/train/train_gde.py), so batching is a gather.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def extract_positions_np(obs: np.ndarray, num_agvs: int) -> np.ndarray:
    """(T, N, 2) (x, y) positions from padded obs — AGVs carry (y, x) at
    indices 3,4, pickers at 0,1; output is (x, y) like the reference
    (train_gde.py:336-355, train_baselines.py:100-114)."""
    T, N, _ = obs.shape
    idx = np.arange(N)
    is_agv = idx < num_agvs
    y = np.where(is_agv[None, :], obs[:, :, 3], obs[:, :, 0])
    x = np.where(is_agv[None, :], obs[:, :, 4], obs[:, :, 1])
    return np.stack([x, y], axis=-1).astype(np.float32)


@dataclasses.dataclass
class TrajectoryDataset:
    """Episodes of logged observations with window-indexed access."""

    episodes: List[np.ndarray]  # each (T, N, D) float32
    num_agvs: int
    num_pickers: int
    seq_len: int

    def __post_init__(self):
        # window index: (episode, end_step) such that end_step + 1 exists.
        self._index: List[Tuple[int, int]] = []
        for e, ep in enumerate(self.episodes):
            T = ep.shape[0]
            for t in range(T - 1):
                self._index.append((e, t))

    # ------------------------------------------------------------------
    @property
    def _positions(self) -> List[np.ndarray]:
        """Per-episode (T, N, 2) positions, computed lazily on first use
        (the device-resident trainer paths stack these; window() extracts
        positions from its own slice instead, so pure loading never pays
        the whole-dataset pass)."""
        cached = self.__dict__.get("_positions_cache")
        if cached is None:
            cached = [
                extract_positions_np(np.asarray(ep, np.float32),
                                     self.num_agvs)
                for ep in self.episodes
            ]
            self.__dict__["_positions_cache"] = cached
        return cached

    @property
    def obs_dim(self) -> int:
        return self.episodes[0].shape[2]

    @property
    def num_agents(self) -> int:
        return self.episodes[0].shape[1]

    def __len__(self) -> int:
        return len(self._index)

    def window(self, i: int):
        """Returns (obs_window (W, N, D), valid_count, next_pos (N, 2),
        pos_window (W, N, 2)).

        The window ends at step t (newest frame == frame at t); frames
        before episode start are zero-padded with valid_count < W —
        mirroring the reference's warm-up deque (train_gde.py:114).
        """
        e, t = self._index[i]
        W = self.seq_len
        ep = self.episodes[e]
        lo = max(0, t - W + 1)
        frames = ep[lo : t + 1]
        count = frames.shape[0]
        obs_w = np.zeros((W, ep.shape[1], ep.shape[2]), np.float32)
        obs_w[:count] = frames
        # Positions extracted lazily from the slice (episodes may be
        # memory-mapped float16 views; upcasting here is exact and avoids
        # materializing whole-dataset position arrays at load).
        pos_slice = extract_positions_np(
            np.asarray(ep[lo : t + 2], np.float32), self.num_agvs
        )
        pos_w = np.zeros((W, ep.shape[1], 2), np.float32)
        pos_w[:count] = pos_slice[:count]
        next_pos = pos_slice[count]
        return obs_w, count, next_pos, pos_w

    def batch(self, indices: Sequence[int]):
        """Gather a batch: dict of stacked numpy arrays."""
        obs, counts, nxt, pos = zip(*(self.window(i) for i in indices))
        return {
            "obs": np.stack(obs),  # (B, W, N, D)
            "count": np.asarray(counts, np.int32),  # (B,)
            "next_pos": np.stack(nxt),  # (B, N, 2)
            "pos": np.stack(pos),  # (B, W, N, 2)
        }

    # ------------------------------------------------------------------
    @staticmethod
    def _load_file(path: str, cache: bool = True, limit: Optional[int] = None):
        """Episodes of one HDF5 file as a list of (T, N, D) arrays.

        With cache=True (default) the decoded observations are stored in
        a memory-mapped sidecar (`<path>.obscache.npy` + offsets in
        `.obscachemeta.npz`, keyed by the source file's mtime): gzip'd
        HDF5 chunk decode is the dominant load cost on small hosts
        (measured ~1h for 5 large files on a 1-vCPU box), and every
        trainer/eval stage re-loads the same files. Cache hits mmap in
        milliseconds and fault pages in on first touch; values are
        bit-identical (the sidecar stores the stored dtype, upcast to
        float32 exactly where the old path cast at load)."""
        import os

        obs_path = path + ".obscache.npy"
        meta_path = path + ".obscachemeta.npz"
        src_mtime = os.path.getmtime(path)
        if cache and os.path.exists(obs_path) and os.path.exists(meta_path):
            try:
                meta = np.load(meta_path)
                if float(meta["src_mtime"]) == src_mtime:
                    arr = np.load(obs_path, mmap_mode="r")
                    offs = meta["offsets"]
                    n = len(offs) - 1 if limit is None else min(
                        limit, len(offs) - 1
                    )
                    eps = [arr[offs[i]: offs[i + 1]] for i in range(n)]
                    return (eps, int(meta["num_agvs"]),
                            int(meta["num_pickers"]))
            except (OSError, KeyError, ValueError):
                pass  # corrupt/foreign sidecar: rebuild below

        import h5py

        def _decode(steps, schema_attr):
            if schema_attr in ("columnar_v1", b"columnar_v1") or isinstance(
                steps.get("observations"), h5py.Dataset
            ):
                return steps["observations"][:]
            return np.stack(
                [steps[s]["observations"][:] for s in sorted(steps.keys())]
            )

        episodes: List[np.ndarray] = []
        num_agvs = num_pickers = None
        with h5py.File(path, "r") as f:
            ep_names = sorted(k for k in f.keys() if k.startswith("episode_"))
            truncated = limit is not None and limit < len(ep_names)
            if truncated:
                ep_names = ep_names[:limit]
            build = bool(cache and not truncated and ep_names)
            writer = offsets = None
            if build:
                # Stream episodes straight into a file-backed memmap:
                # anonymous page faults can run at only a few MB/s on some
                # virtualized hosts (measured ~4-30 MB/s here), so a
                # np.concatenate of the whole file is the single slowest
                # step of a load. Shapes come from HDF5 metadata (cheap);
                # each episode is decoded exactly once.
                try:
                    shapes = [
                        f[n]["steps"]["observations"].shape
                        if isinstance(
                            f[n]["steps"].get("observations"), h5py.Dataset
                        )
                        else (
                            len(f[n]["steps"]),
                        ) + f[n]["steps"][
                            sorted(f[n]["steps"].keys())[0]
                        ]["observations"].shape
                        for n in ep_names
                    ]
                    dtype = f[ep_names[0]]["steps"]["observations"].dtype \
                        if isinstance(
                            f[ep_names[0]]["steps"].get("observations"),
                            h5py.Dataset,
                        ) else f[ep_names[0]]["steps"][
                            sorted(f[ep_names[0]]["steps"].keys())[0]
                        ]["observations"].dtype
                    offsets = np.zeros(len(shapes) + 1, np.int64)
                    offsets[1:] = np.cumsum([s[0] for s in shapes])
                    tmp_obs = obs_path + ".tmp.npy"
                    writer = np.lib.format.open_memmap(
                        tmp_obs, mode="w+", dtype=dtype,
                        shape=(int(offsets[-1]),) + tuple(shapes[0][1:]),
                    )
                except OSError:
                    writer = None  # read-only dir: fall back to plain load
            for i, name in enumerate(ep_names):
                ep = f[name]
                if num_agvs is None:
                    num_agvs = int(ep["metadata"].attrs["num_agvs"])
                    num_pickers = int(ep["metadata"].attrs["num_pickers"])
                obs = _decode(ep["steps"], ep.attrs.get("schema", b""))
                if writer is not None:
                    writer[offsets[i]: offsets[i + 1]] = obs
                else:
                    episodes.append(obs)
        if writer is not None:
            writer.flush()
            del writer
            final = tmp_obs
            try:
                os.replace(tmp_obs, obs_path)
                final = obs_path
                np.savez(
                    meta_path + ".tmp.npz", offsets=offsets,
                    num_agvs=num_agvs, num_pickers=num_pickers,
                    src_mtime=src_mtime,
                )
                os.replace(meta_path + ".tmp.npz", meta_path)
            except OSError:
                pass  # sidecar incomplete; data still served from `final`
            arr = np.load(final, mmap_mode="r")
            episodes = [
                arr[offsets[i]: offsets[i + 1]]
                for i in range(len(offsets) - 1)
            ]
        return episodes, num_agvs, num_pickers

    @staticmethod
    def from_h5(
        paths: Sequence[str],
        seq_len: int = 5,
        max_episodes: Optional[int] = None,
        cache: bool = True,
    ) -> "TrajectoryDataset":
        """Load from HDF5: accepts both the reference group-per-step
        schema (train_gde.py:293-332) and the columnar_v1 schema (stacked
        (T, ...) datasets; swarm_ode_tpu/data/hdf5_logger.py). Decoding a
        file needs h5py; a file whose sidecar is current does not."""
        episodes: List[np.ndarray] = []
        num_agvs = num_pickers = None
        for path in paths:
            room = (max_episodes - len(episodes)) if max_episodes else None
            eps, na, npk = TrajectoryDataset._load_file(
                path, cache=cache, limit=room
            )
            if num_agvs is None:
                num_agvs, num_pickers = na, npk
            episodes.extend(eps[:room] if room is not None else eps)
            if max_episodes and len(episodes) >= max_episodes:
                break
        return TrajectoryDataset(
            episodes=episodes,
            num_agvs=num_agvs,
            num_pickers=num_pickers,
            seq_len=seq_len,
        )


def train_val_split(
    n: int, val_frac: float = 0.2, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """80/20 random split (reference train_gde.py:448-450)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_val = int(n * val_frac)
    return perm[n_val:], perm[:n_val]


def main(argv=None) -> None:
    """`build-cache [globs ...]`: scripts/build_obs_cache.py. Builds the
    observation sidecars of every HDF5 file the globs match (default
    datasets/*.h5) up front, through `TrajectoryDataset._load_file(cache=True)`,
    so that every later trainer and evaluator maps them (no h5py needed
    then). A host path: it decodes HDF5 (h5py) and moves no tensor, so it
    takes no --device."""
    import argparse
    import glob
    import time

    p = argparse.ArgumentParser(description=main.__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    b = sub.add_parser("build-cache", help="pre-build the .obscache sidecars")
    b.add_argument("globs", nargs="*", default=["datasets/*.h5"])
    args = p.parse_args(argv)
    files = sorted({f for pat in args.globs for f in glob.glob(pat)})
    for f in files:
        t0 = time.time()
        eps, na, npk = TrajectoryDataset._load_file(f, cache=True)
        print(f"{f}: {len(eps)} episodes, {na}+{npk} agents, {time.time() - t0:.0f}s",
              flush=True)
        del eps


if __name__ == "__main__":
    main()
