"""The port's datagen against the JAX package's: `_capture` on the same
states, `collect_batch` against JAX's chunked scan from the same resets
with the same draws, the HDF5 logger against JAX's logger on the same
arrays in both schemas, and `collect_data` end to end, its file read by
both packages' TrajectoryDataset. Files go under pytest's tmp_path."""
import pathlib
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.data import collect as jcollect
from swarm_ode_tpu.data.dataset import TrajectoryDataset as JDataset
from swarm_ode_tpu.data.hdf5_logger import HDF5Logger as JLogger
from swarm_ode_tpu.data.hdf5_logger import write_batch_trajectories as jwrite_batch
from swarm_ode_tpu.env import step as jstep
from swarm_ode_tpu.policies import heuristic as jheur
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.data import collect as pcollect
from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset as PDataset
from swarm_ode_tpu_torch.data.hdf5_logger import HDF5Logger as PLogger
from swarm_ode_tpu_torch.data.hdf5_logger import write_batch_trajectories as pwrite_batch
from torch_port_helpers import (
    MEDIUM,
    TINY,
    assert_same,
    both,
    fields,
    jax_heuristic_init,
    jax_noise,
    jax_policy_fn,
    jax_reset_batch,
    jax_step_fn,
    numpy_dict,
    torch_dict,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_id,B,T", [
    (TINY, 3, 20), (MEDIUM, 2, 10), ("tarware-small-5agvs-0pickers-globalobs-v1", 2, 8),
])
def test_capture_matches_jax(env_id, B, T):
    jp, jl, pp, _ = both(env_id)
    policy, step = jax_policy_fn(jp, jl), jax_step_fn(jp)
    capture = jax.jit(jax.vmap(lambda s, a: jcollect._capture(jp, s, a)))
    js, jh = jax_reset_batch(jp, B, seed=12), jax_heuristic_init(jp, B)
    for t in range(T):
        ja, jh = policy(js, jh)
        want = numpy_dict(capture(js, ja))
        got = pcollect._capture(
            pp, convert.env_state_from_numpy(fields(js), device="cpu"),
            torch.from_numpy(np.array(ja)))
        assert_same(want, torch_dict(got), f"step {t}")
        js, _, _, _ = step(js, ja)


def _jax_collect(jp, jl, js0, steps, chunk):
    """JAX's collect_data rollout (collect.py:81-121) from given resets:
    vmapped chunks of the scanned capture + step, cut to `steps`."""
    policy = jheur.make_policy(jp, jl)

    @jax.jit
    def run_chunk(es, hs):
        def one(es, hs):
            def body(carry, _):
                es, hs = carry
                actions, hs = policy(jp, es, hs)
                snap = jcollect._capture(jp, es, actions)
                es, rew, done, info = jstep.step(jp, es, actions)
                snap["rewards"] = rew
                snap["info_shelf_deliveries"] = info["shelf_deliveries"]
                snap["info_clashes"] = info["clashes"]
                snap["info_stucks"] = info["stucks"]
                return (es, hs), snap
            (es, hs), traj = jax.lax.scan(body, (es, hs), None, length=chunk)
            return es, hs, traj

        return jax.vmap(one)(es, hs)

    es, hs = js0, jax_heuristic_init(jp, js0.agent_xy.shape[0])
    chunks = []
    for _ in range(int(np.ceil(steps / chunk))):
        es, hs, traj = run_chunk(es, hs)
        chunks.append(jax.tree.map(np.asarray, traj))
    return {k: np.concatenate([c[k] for c in chunks], axis=1)[:, :steps] for k in chunks[0]}


def test_collect_batch_matches_jax():
    """Chunks of 7 over 25 steps (the last one short): every captured key of
    every step equals JAX's, dtypes included."""
    jp, jl, pp, pl = both(TINY)
    B, steps, chunk = 3, 25, 7
    js0 = jax_reset_batch(jp, B, seed=30)
    want = _jax_collect(jp, jl, js0, steps, chunk)
    noise, keys = [], js0.key
    for _ in range(steps):
        n, keys = jax_noise(jp, keys)
        noise.append(n)
    got, stats = pcollect.collect_batch(
        pp, pl, B, steps, chunk,
        state=convert.env_state_from_numpy(fields(js0), device="cpu"), noise=noise)
    assert set(got) == set(want)
    assert_same(want, got, "collect_batch")
    np.testing.assert_array_equal(stats["deliveries"], want["info_shelf_deliveries"].sum(1))
    assert int(stats["replan_overflow"].sum()) == 0 and stats["deliveries"].sum() > 0


def _walk(f):
    """{path: ("group", attrs) | ("dataset", attrs, dtype, shape, values,
    compression, level)} of every object in an HDF5 file."""
    out = {}

    def attrs(obj):
        return {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = ("dataset", attrs(obj), obj.dtype, obj.shape, obj[()],
                         obj.compression, obj.compression_opts)
        else:
            out[name] = ("group", attrs(obj))

    f.visititems(visit)
    return out


def _assert_same_file(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        wa, wb = _walk(fa), _walk(fb)
    assert sorted(wa) == sorted(wb)
    for k in wa:
        ea, eb = wa[k], wb[k]
        assert ea[:2] == eb[:2], k
        if ea[0] == "dataset":
            assert ea[2] == eb[2] and ea[3] == eb[3], k
            np.testing.assert_array_equal(ea[4], eb[4], err_msg=k)
            assert ea[5:] == eb[5:], k
            if "steps/" in k:  # the logged steps are gzip'd, level 1
                assert ea[5:] == ("gzip", 1), k


@pytest.mark.parametrize("schema", ["columnar", "reference"])
def test_hdf5_logger_matches_jax(tmp_path, schema):
    """The same arrays through both loggers give the same file: groups,
    attrs, dataset dtypes, shapes and values, gzip level 1."""
    jp, jl, pp, pl = both(TINY)
    traj, _ = pcollect.collect_batch(pp, pl, 2, 6, 4, torch.Generator().manual_seed(0))
    seeds = np.array([40, 41])
    for logger_cls, params, path in ((JLogger, jp, tmp_path / "jax.h5"),
                                     (PLogger, pp, tmp_path / "port.h5")):
        logger = logger_cls(str(path), schema=schema)
        for b in range(2):
            logger.start_episode(b, int(seeds[b]), params, jl.rack_locations_xyg)
            for t in range(6):
                logger.log_step({k: v[b, t] for k, v in traj.items()})
            logger.end_episode()
        logger.close()
    _assert_same_file(tmp_path / "jax.h5", tmp_path / "port.h5")
    if schema == "reference":
        jwrite_batch(str(tmp_path / "jb.h5"), jp, jl.rack_locations_xyg, traj, seeds, 3)
        pwrite_batch(str(tmp_path / "pb.h5"), pp, jl.rack_locations_xyg, traj, seeds, 3)
        _assert_same_file(tmp_path / "jb.h5", tmp_path / "pb.h5")


def _load_both(path):
    p = PDataset.from_h5([str(path)], cache=False)
    j = JDataset.from_h5([str(path)], cache=False)
    assert (p.num_agvs, p.num_pickers) == (j.num_agvs, j.num_pickers)
    assert len(p.episodes) == len(j.episodes)
    for a, b in zip(p.episodes, j.episodes):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return p


def test_collect_data_end_to_end(tmp_path, capsys):
    """Two tiny episodes in one batch, chunks of 7 (not a divisor of 500):
    the file loads through both packages' TrajectoryDataset into equal
    arrays and holds JAX's attrs and episode line."""
    out = tmp_path / "a.h5"
    stats = pcollect.collect_data(TINY, 2, seed=70, out_path=str(out), batch=2, chunk=7,
                                  device="cpu")
    assert stats["episodes"] == 2 and len(stats["deliveries"]) == 2
    assert min(stats["deliveries"]) > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Env: ")]
    assert lines[0].startswith(f"Env: {TINY} | Seed: 70 | Episode 0: | [Overall Pick Rate=")
    ds = _load_both(out)
    assert ds.episodes[0].shape == (500, 5, 119)
    with h5py.File(out, "r") as f:
        assert [f[f"episode_{i:06d}/metadata"].attrs["seed"] for i in range(2)] == [70, 71]
        assert f["episode_000000"].attrs["schema"] == "columnar_v1"
        assert f["episode_000001/summary"].attrs["episode_length"] == 500
        d = int(f["episode_000001/steps/info_shelf_deliveries"][()].sum())
        assert d == stats["deliveries"][1]


def test_collect_cli(tmp_path, capsys):
    """`python -m swarm_ode_tpu_torch.data.collect`: --help, then one tiny
    episode on the CPU into tmp_path under the reference's file name. The
    same seed and batch write the same file again (through collect_data),
    and a complete file is skipped."""
    cmd = [sys.executable, "-m", "swarm_ode_tpu_torch.data.collect"]
    res = subprocess.run(cmd + ["--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "--device" in res.stdout and "--num_episodes" in res.stdout
    res = subprocess.run(
        cmd + ["--env_ids", TINY, "--seeds", "5", "--num_episodes", "1", "--batch", "1",
               "--out_dir", str(tmp_path), "--schema", "columnar", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    path = tmp_path / f"warehouse_data_{TINY}_seed5.h5"
    assert f"Seed: 5 | Episode 0:" in res.stdout
    assert len(_load_both(path).episodes) == 1
    again = tmp_path / "again.h5"
    pcollect.collect_data(TINY, 1, seed=5, out_path=str(again), batch=1, device="cpu",
                          verbose=False)
    _assert_same_file(path, again)
    pcollect.main(["--env_ids", TINY, "--seeds", "5", "--num_episodes", "1",
                   "--out_dir", str(tmp_path), "--device", "cpu"])
    assert "Skipping" in capsys.readouterr().out
