"""The port's copy of the trajectory dataset against the JAX package's.

Fixtures are decoded with cache=False, or copied under tmp_path where the
`.obscache.npy` sidecars are written, so nothing under tests/fixtures/
changes.
"""
import pathlib
import shutil

import numpy as np
import pytest

from swarm_ode_tpu.data import dataset as jdataset
from swarm_ode_tpu_torch.data import dataset as pdataset

FIXTURES = sorted((pathlib.Path(__file__).parent / "fixtures" / "datasets").glob("*.h5"))


def _both(paths, **kw):
    return (jdataset.TrajectoryDataset.from_h5(paths, cache=False, **kw),
            pdataset.TrajectoryDataset.from_h5(paths, cache=False, **kw))


@pytest.mark.parametrize("seq_len", [3, 5])
def test_windows_match_jax(seq_len):
    """Two fixture files, capped at 3 episodes: the same episodes, index,
    positions, windows (every 7th, the warm-up ones and the last of each
    episode), batches and split as the JAX package's."""
    j, p = _both([str(f) for f in FIXTURES[:2]], seq_len=seq_len, max_episodes=3)
    assert (p.num_agvs, p.num_pickers, p.obs_dim, p.num_agents, len(p)) == (
        j.num_agvs, j.num_pickers, j.obs_dim, j.num_agents, len(j))
    assert len(p.episodes) == 3 and p._index == j._index
    for a, b in zip(p.episodes, j.episodes):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p._positions, j._positions):
        np.testing.assert_array_equal(a, b)
    T = p.episodes[0].shape[0]
    picks = sorted(set(range(0, len(p), 7)) | {0, 1, 2, T - 2, T - 1, len(p) - 1})
    for i in picks:
        for a, b in zip(p.window(i), j.window(i)):
            np.testing.assert_array_equal(a, b)
    pb, jb = p.batch(picks), j.batch(picks)
    assert pb.keys() == jb.keys()
    for k in pb:
        assert pb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(pb[k], jb[k])
    for a, b in zip(pdataset.train_val_split(len(p), 0.2, 3),
                    jdataset.train_val_split(len(j), 0.2, 3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pdataset.extract_positions_np(p.episodes[1], p.num_agvs),
                                  jdataset.extract_positions_np(j.episodes[1], j.num_agvs))


def test_cache_hits_equal_misses(tmp_path):
    """A copy of a fixture in tmp_path: the first cached load builds the
    sidecar, the second reads it (memory-mapped); both equal the uncached
    decode, and each package reads the sidecar the other wrote."""
    src = tmp_path / "a" / FIXTURES[0].name
    src.parent.mkdir()
    shutil.copy(FIXTURES[0], src)
    miss = pdataset.TrajectoryDataset.from_h5([str(src)], cache=False)
    built = pdataset.TrajectoryDataset.from_h5([str(src)])
    assert pathlib.Path(str(src) + ".obscache.npy").exists()
    hit = pdataset.TrajectoryDataset.from_h5([str(src)])
    assert isinstance(hit.episodes[0], np.memmap)
    jhit = jdataset.TrajectoryDataset.from_h5([str(src)])
    for ds in (built, hit, jhit):
        assert (ds.num_agvs, ds.num_pickers, len(ds.episodes)) == (
            miss.num_agvs, miss.num_pickers, len(miss.episodes))
        for a, b in zip(ds.episodes, miss.episodes):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    other = tmp_path / "b" / FIXTURES[1].name
    other.parent.mkdir()
    shutil.copy(FIXTURES[1], other)
    jdataset.TrajectoryDataset.from_h5([str(other)])
    phit = pdataset.TrajectoryDataset.from_h5([str(other)])
    assert isinstance(phit.episodes[0], np.memmap)
    for a, b in zip(phit.episodes, pdataset.TrajectoryDataset.from_h5([str(other)],
                                                                       cache=False).episodes):
        np.testing.assert_array_equal(a, b)
