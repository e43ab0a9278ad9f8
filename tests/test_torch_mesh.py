"""Data parallelism in the port (parallel/mesh.py over torch.distributed)
against the JAX package's mesh, on the CPU, as tests/test_mesh_parallel.py
and tests/test_mappo.py::test_mappo_mesh_parity hold the JAX package.

Several ranks are gloo processes that parallel.mesh.launch starts (a file
store, no TCP port); their functions live in the port or in
torch_port_helpers, so a rank imports no test file. A run on one rank is
the same function in this process, with no process group. Tolerances are
stated per test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_helpers as helpers
from swarm_ode_tpu.graphs.temporal import TemporalWindow, build_temporal_graph
from swarm_ode_tpu.models.gde import GraphODE as JGraphODE
from swarm_ode_tpu.parallel import mesh as jmesh
from swarm_ode_tpu.train.train_gde import _batch_loss as j_batch_loss
from swarm_ode_tpu_torch import convert, entry
from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
from swarm_ode_tpu_torch.parallel import mesh as pmesh
from swarm_ode_tpu_torch.rl import ppo
from swarm_ode_tpu_torch.train import train_baselines, train_gde

TINY = "tarware-tiny-3agvs-2pickers-partialobs-v1"
RANKS = 4


def _port_mesh(jm, device) -> pmesh.Mesh:
    """The port's view of the mesh from the rank that drives `device` of
    the JAX mesh `jm` (no process group: shard_batch needs none)."""
    pos = np.argwhere(jm.devices == device)[0]
    names = tuple(jm.axis_names)
    return pmesh.Mesh(names, dict(jm.shape), dict(zip(names, map(int, pos))),
                      torch.device("cpu"), {a: None for a in names})


@pytest.mark.parametrize("multiple", [4, 8])
def test_pad_and_shard_match_jax(multiple):
    """pad_to_multiple (B = 5) equals JAX's, and each rank's shard_batch
    rows are the rows JAX's device at the same mesh position holds under
    P('dp'), on the 8-device mesh and on a dp 4 x mp 2 one."""
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    b = np.arange(5, dtype=np.int32)
    jpad, jmask = jmesh.pad_to_multiple({"a": jnp.asarray(a), "b": jnp.asarray(b)}, multiple)
    ppad, pmask = pmesh.pad_to_multiple({"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                                        multiple)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    for k in ("a", "b"):
        np.testing.assert_array_equal(ppad[k].numpy(), np.asarray(jpad[k]))
        assert ppad[k].dtype == torch.from_numpy(np.array(jpad[k])).dtype
    rows = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    for jm in (jmesh.make_mesh(("dp",)), jmesh.make_mesh(("dp", "mp"), shape=(4, 2))):
        sharded = jmesh.shard_batch(jm, {"x": jnp.asarray(rows)})["x"]
        assert len(sharded.addressable_shards) == 8
        for shard in sharded.addressable_shards:
            mine = pmesh.shard_batch(_port_mesh(jm, shard.device), {"x": torch.from_numpy(rows)})
            np.testing.assert_array_equal(mine["x"].numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_batch(_port_mesh(jm, jm.devices.flat[0]), torch.zeros(6))


def _jax_step(jmodel, params, batch):
    """JAX's train step (tests/test_mesh_parallel.py::_train_step) on one
    device at HIGHEST precision: (loss, updated parameters)."""
    loss_fn = j_batch_loss(jmodel, 3, 5.0)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))

    @jax.jit
    def step(params, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, optax.apply_updates(params, updates)

    with jax.default_matmul_precision("highest"):
        loss, new = step(params, batch)
    return float(loss), new


def _jax_init(jmodel, batch):
    w0 = TemporalWindow(obs=batch["obs"][0], count=batch["count"][0])
    return jmodel.init(jax.random.PRNGKey(0), build_temporal_graph(w0, 3), jnp.array([0.0, 1.0]))


def _assert_step(got, loss, params, tol):
    assert abs(got["loss"] - loss) < tol
    for k, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), params[k].numpy(), rtol=0, atol=tol, err_msg=k)


def test_dp_step_matches_one_rank_and_jax():
    """One GDE train step with the batch of 8 split over 4 dp ranks equals
    the step on one rank and JAX's step (_model_and_batch of
    test_mesh_parallel: hidden 8, 16 features, JAX's init converted): loss
    and parameters within 1e-6."""
    rng = np.random.RandomState(0)
    obs = rng.rand(8, 5, 5, 16).astype(np.float32)
    nxt = rng.rand(8, 5, 2).astype(np.float32)
    jbatch = {"obs": jnp.asarray(obs), "count": jnp.full((8,), 5, jnp.int32),
              "next_pos": jnp.asarray(nxt), "weight": jnp.ones((8,), jnp.float32)}
    jmodel = JGraphODE(node_dim=16, num_agvs=3, hidden_dim=8)
    jparams = _jax_init(jmodel, jbatch)
    jloss, jnew = _jax_step(jmodel, jparams, jbatch)
    init = convert.gde_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    step = functools.partial(entry.mesh_train_step, dict(node_dim=16, num_agvs=3, hidden_dim=8),
                             init, batch)
    one = step()
    ranks = pmesh.launch(step, RANKS)
    want = convert.gde_params_from_numpy(jax.tree.map(np.asarray, jnew), device="cpu")
    _assert_step(one, jloss, want, 1e-6)
    for got in ranks:
        _assert_step(got, one["loss"], one["params"], 1e-6)


def test_dryrun_multichip_matches_jax(capsys):
    """dryrun_multichip(4) (dp 2 x mp 2, the conv1 / conv2 leaves stored as
    shards on mp) from JAX's init of the flagship, converted: its loss and
    updated parameters within 1e-5 of JAX's step on the same batch."""
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in entry.example_batch("cpu", batch=4).items()}
    jmodel = JGraphODE(node_dim=119, hidden_dim=64, ode_solver="euler")
    jparams = _jax_init(jmodel, jbatch)
    jloss, jnew = _jax_step(jmodel, jparams, jbatch)
    got = entry.dryrun_multichip(
        4, params=convert.gde_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"))
    assert f"dryrun_multichip OK: mesh dp=2 mp=2, loss={got['loss']:.4f}" in capsys.readouterr().out
    _assert_step(got, jloss, convert.gde_params_from_numpy(jax.tree.map(np.asarray, jnew),
                                                           device="cpu"), 1e-5)


def _dataset(steps=80):
    """The first tiny fixture's 2 episodes cut to `steps` steps (decoded
    with cache=False: nothing under tests/fixtures/ is written)."""
    fixture = sorted((helpers.REPO / "tests" / "fixtures" / "datasets").glob("*.h5"))[0]
    eps, na, npk = TrajectoryDataset._load_file(str(fixture), cache=False, limit=2)
    return TrajectoryDataset(episodes=[np.asarray(e[:steps], np.float32) for e in eps],
                             num_agvs=na, num_pickers=npk, seq_len=5)


def _assert_same_run(got, want):
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5, err_msg=k)
    for k, v in want["final_params"].items():
        np.testing.assert_allclose(got["final_params"][k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


TRAINERS = {
    "gde-B16": ("gde", dict(batch_size=16)),
    "gde-B6": ("gde", dict(batch_size=6)),
    "gde-host-B6": ("gde", dict(batch_size=6, device_data=False)),
    "baseline-B16": ("baseline", dict(batch_size=16)),
    "baseline-host-B6": ("baseline", dict(batch_size=6, device_data=False)),
}


@pytest.mark.parametrize("case", sorted(TRAINERS))
def test_trainers_on_four_ranks_match_one(case):
    """train_gde and train_baseline (gru) for 2 epochs over 2 tiny episodes
    of 80 steps, hidden 16, on 4 gloo ranks: B = 16 splits over them, B = 6
    does not (resident batches computed whole on every rank, host batches
    padded with weight-0 windows and split); every rank's history within
    rtol 1e-5 of the one-rank run's and its final parameters within 1e-5
    (the tolerance the one-rank trainer is held to against JAX)."""
    which, kw = TRAINERS[case]
    ds = _dataset()
    if which == "gde":
        fn = functools.partial(train_gde.train_gde, ds,
                               train_gde.GDETrainConfig(num_epochs=2, hidden_dim=16, **kw),
                               verbose=False, device="cpu")
    else:
        cfg = train_baselines.BaselineTrainConfig(model="gru", num_epochs=2, hidden_dim=16,
                                                  device="cpu", **kw)
        fn = functools.partial(train_baselines.train_baseline, ds, cfg, verbose=False)
    one = fn()
    assert one["history"]["train_loss"][1] < one["history"]["train_loss"][0]
    for got in pmesh.launch(fn, RANKS):
        _assert_same_run(got, one)


def test_sharded_rollout_equals_unsharded():
    """A heuristic rollout of 8 tiny envs over 12 steps, the envs split over
    4 ranks (each drawing for all 8 and keeping its 2): every env's
    positions, actions, rewards and deliveries equal the unsharded run's,
    bit for bit (test_mesh_parallel's rollout test)."""
    args = (TINY, 8, 12, 7)
    whole = helpers.sharded_heuristic_rollout(*args)
    parts = pmesh.launch(functools.partial(helpers.sharded_heuristic_rollout, *args), RANKS)
    for k, v in whole.items():
        assert torch.equal(torch.cat([p[k] for p in parts], dim=1), v), k


def test_mappo_on_four_ranks_matches_one_rank():
    """run_mappo at test_mappo_mesh_parity's config (4 tiny envs, gnn,
    hidden 8, 2 strides of 30 steps, coordinated, seed 3) with
    mesh_devices=4 on 4 ranks against mesh_devices=0: pick_rate and
    deliveries exactly equal (each env's arithmetic is the one-rank run's),
    the losses within rtol 1e-4 / atol 1e-5 and the actor within rtol 1e-4
    / atol 1e-6, as JAX's test holds its mesh; every rank returns the
    same."""
    kw = dict(env_id=TINY, net="gnn", hidden_dim=8, num_envs=4, num_strides=2,
              steps_override=30, minibatch=16, ppo_epochs=1, coordinated=True, seed=3,
              device="cpu")
    single = ppo.run_mappo(ppo.MAPPOConfig(**kw), verbose=False)
    ranks = pmesh.launch(functools.partial(ppo.run_mappo, ppo.MAPPOConfig(**kw, mesh_devices=4),
                                           verbose=False), RANKS)
    for out in ranks:
        for a, b in zip(single["history"], out["history"]):
            assert a["pick_rate"] == b["pick_rate"] and a["deliveries"] == b["deliveries"]
            for k in ("pg_loss", "v_loss"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5, err_msg=k)
        for k, v in single["actor_params"].items():
            np.testing.assert_allclose(out["actor_params"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert all(torch.equal(out["actor_params"][k], v)
                   for k, v in ranks[0]["actor_params"].items())


def test_a_failing_rank_fails_the_launch():
    """launch raises, with the rank's error, when a rank fails: MAPPO with
    mesh_devices=3 on a group of 2 ranks."""
    cfg = ppo.MAPPOConfig(env_id=TINY, num_envs=6, mesh_devices=3, device="cpu")
    with pytest.raises(RuntimeError, match="mesh_devices=3 needs a process group"):
        pmesh.launch(functools.partial(ppo.MappoRun, cfg), 2)
