"""GDE training in the port against the JAX package's, on the CPU.

The data are the committed tiny fixtures (tarware-tiny-3agvs-2pickers, 5
agents x 119 features), decoded with cache=False so that nothing under
tests/fixtures/ is written; the models are narrow (hidden 16). The port
starts from the JAX model's own init, converted (convert.gde_params_from_numpy),
and JAX runs at HIGHEST matmul precision. Tolerances are stated per test.
"""
import dataclasses
import functools
import importlib.util
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swarm_ode_tpu.data.dataset import TrajectoryDataset as JDataset
from swarm_ode_tpu.graphs import temporal as jt
from swarm_ode_tpu.models.gde import GraphODE as JGraphODE
from swarm_ode_tpu.train import train_gde as jtrain
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.train import train_gde as ptrain
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures" / "datasets").glob("*.h5"))
HIDDEN, STEPS = 16, 80
TRAIN = dict(num_epochs=2, batch_size=16, hidden_dim=HIDDEN)


def _episodes(n=2, steps=STEPS):
    """n episodes of the first fixture, cut to `steps` steps, float32."""
    eps, na, npk = TrajectoryDataset._load_file(str(FIXTURES[0]), cache=False, limit=n)
    return [np.asarray(e[:steps], np.float32) for e in eps], na, npk


def _datasets(**kw):
    eps, na, npk = _episodes(**kw)
    return (JDataset(episodes=eps, num_agvs=na, num_pickers=npk, seq_len=5),
            TrajectoryDataset(episodes=eps, num_agvs=na, num_pickers=npk, seq_len=5))


@functools.lru_cache(maxsize=1)
def _jax_init():
    """The JAX trainer's own init (PRNGKey(seed) on its sample window) for
    _datasets(): a run of 0 epochs returns it."""
    jds, _ = _datasets()
    return jtrain.train_gde(jds, jtrain.GDETrainConfig(**{**TRAIN, "num_epochs": 0}),
                            verbose=False)["params"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _as_state_dict(tree):
    return convert.gde_params_from_numpy(_np(tree), device="cpu")


def _batch(jds, pairs, horizon):
    """A loss batch cut by the JAX package's _extract_windows, as numpy."""
    episodes = jnp.asarray(np.stack(jds.episodes))
    positions = np.stack(jds._positions)
    if horizon > 1:
        positions = np.pad(positions, ((0, 0), (0, horizon), (0, 0), (0, 0)), mode="edge")
    cut = jtrain._extract_windows(episodes, jnp.asarray(positions), jds.seq_len,
                                  jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]),
                                  horizon=horizon, true_len=jds.episodes[0].shape[0])
    batch = dict(zip(("obs", "count", "next_pos", "hweight"), (np.asarray(c) for c in cut)))
    batch["weight"] = np.ones(len(pairs), np.float32)
    batch["weight"][1] = 0.0  # a window that does not count
    return batch


@pytest.mark.parametrize("horizon,weights", [(1, None), (4, None), (4, (3.0, 1.0, 1.0, 1.0))])
def test_batch_loss_matches_jax(horizon, weights):
    """Loss and gradients of every parameter against JAX
    value_and_grad(_batch_loss) on windows with count < W (steps 0-2 of an
    episode), windows whose horizon runs past the episode's end (hweight
    zeros) and a window of weight 0. 1e-5 relative to the largest
    magnitude of each gradient."""
    jds, _ = _datasets()
    T = STEPS
    pairs = np.array([[0, 0], [0, 1], [1, 2], [0, 40], [1, 61], [0, T - 4], [1, T - 3],
                      [0, T - 2], [1, T - 2]], np.int32)
    batch = _batch(jds, pairs, horizon)
    if horizon > 1:
        assert batch["hweight"].min() == 0.0 and (batch["count"] < 5).any()
    jmodel = JGraphODE(node_dim=119, num_agvs=jds.num_agvs, num_pickers=jds.num_pickers,
                       hidden_dim=HIDDEN)
    params = _jax_init()
    loss_j = jtrain._batch_loss(jmodel, jds.num_agvs, 5.0, horizon, weights)
    with jax.default_matmul_precision("highest"):
        ref, gref = jax.value_and_grad(loss_j)(params, jax.tree.map(jnp.asarray, batch))

    model = GraphODE(119, jds.num_agvs, jds.num_pickers, HIDDEN)
    model.load_state_dict(_as_state_dict(params))
    loss = ptrain._batch_loss(model, jds.num_agvs, 5.0, horizon, weights)(
        {k: torch.tensor(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    for name, want in _as_state_dict(gref).items():
        want = want.numpy()
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_extract_windows_matches_jax(horizon, dtype):
    """Every (episode, step) window of two episodes cut by the port equals
    the JAX package's cut, bit for bit, from float32, bfloat16 and uint8
    storage."""
    jds, pds = _datasets()
    jeps, jdt = jtrain.stack_episodes_streamed(jds.episodes, dtype)
    peps, pdt = ptrain.stack_episodes_streamed(pds.episodes, dtype)
    pos = np.stack(jds._positions)
    if horizon > 1:
        pos = np.pad(pos, ((0, 0), (0, horizon), (0, 0), (0, 0)), mode="edge")
    pairs = np.asarray(jds._index, np.int32)
    want = jtrain._extract_windows(jnp.asarray(jeps, jdt), jnp.asarray(pos), 5,
                                   jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]),
                                   horizon=horizon, true_len=STEPS)
    got = ptrain._extract_windows(torch.from_numpy(peps).to(pdt), torch.from_numpy(pos), 5,
                                  torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1]),
                                  horizon=horizon, true_len=STEPS)
    assert len(got) == len(want) == (4 if horizon > 1 else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uint8_storage_refuses_what_jax_refuses():
    """Non-integral or out-of-range observations are refused for uint8
    storage with JAX's message; in-range integral ones are stored exactly."""
    ok = [np.arange(24, dtype=np.float32).reshape(2, 3, 4) * 10]
    for bad in ([ok[0] + 0.5], [ok[0] * 100], [ok[0] - 1]):
        for fn in ("compact_episodes", "stack_episodes_streamed"):
            arg = np.stack(bad) if fn == "compact_episodes" else bad
            with pytest.raises(ValueError) as jerr:
                getattr(jtrain, fn)(arg, "uint8")
            with pytest.raises(ValueError) as perr:
                getattr(ptrain, fn)(arg, "uint8")
            assert str(perr.value) == str(jerr.value)
    arr, dt = ptrain.stack_episodes_streamed(ok, "uint8")
    assert dt == torch.uint8 and arr.dtype == np.uint8 and np.array_equal(arr[0], ok[0])


def test_optimizer_matches_optax():
    """The same 5 numpy gradients (global norms above and below 1.0)
    through optax's chain(clip_by_global_norm(1.0), adamw(1e-3,
    weight_decay=1e-4)) and the port's clip_by_global_norm + adamw_update:
    parameters, mu and nu within 1e-6, count equal; the optimizer state
    round-trips through optax's layout (convert.adamw_state_*)."""
    jds, _ = _datasets()
    params = _jax_init()
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=1e-4))
    state = tx.init(params)
    model = GraphODE(119, jds.num_agvs, jds.num_pickers, HIDDEN)
    model.load_state_dict(_as_state_dict(params))
    names = [n for n, _ in model.named_parameters()]
    plist = list(model.parameters())
    pstate = convert.adamw_state_from_numpy(_np(state), names, device="cpu")
    cfg = ptrain.GDETrainConfig()
    rng = np.random.RandomState(0)
    leaves, treedef = jax.tree.flatten(params)
    norms = []
    for scale in (5.0, 0.2, 30.0, 0.01, 1.5):
        g = [rng.randn(*np.shape(x)).astype(np.float32) for x in leaves]
        norm = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        g = [x * np.float32(scale / norm) for x in g]
        norms.append(scale)
        gtree = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in g])
        upd, state = tx.update(gtree, state, params)
        params = optax.apply_updates(params, upd)
        gsd = _as_state_dict(jax.tree.unflatten(treedef, g))
        with torch.no_grad():
            clipped = ptrain.clip_by_global_norm([gsd[n] for n in names], cfg.grad_clip)
            pstate = ptrain.adamw_update(plist, clipped, pstate, cfg.lr, cfg.weight_decay)
    assert min(norms) < 1.0 < max(norms)
    want = _as_state_dict(params)
    for n, p in zip(names, plist):
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    jstate = convert.adamw_state_from_numpy(_np(state), names, device="cpu")
    assert int(pstate.count) == int(jstate.count) == 5
    for a, b in zip(pstate.mu + pstate.nu, jstate.mu + jstate.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    back = convert.adamw_state_to_numpy(pstate, names)
    rebuilt = jax.tree.unflatten(jax.tree.structure(state), jax.tree.leaves(back))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(_np(state))):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    again = convert.adamw_state_from_numpy(back, names, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.mu + again.nu, pstate.mu + pstate.nu))


def test_clip_is_optax_rule_not_clip_grad_norm():
    """Above the bound each gradient is g / norm * max_norm (global norm
    exactly max_norm afterwards); below it, g itself, untouched (torch's
    clip_grad_norm_ would scale it by max_norm / (norm + 1e-6))."""
    g = [torch.full((3,), 0.3), torch.full((2, 2), 0.1)]
    same = ptrain.clip_by_global_norm(g, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(same, g))
    big = [x * 10 for x in g]
    out = ptrain.clip_by_global_norm(big, 1.0)
    norm = torch.sqrt(sum((x * x).sum() for x in big))
    assert all(torch.equal(o, x / norm * 1.0) for o, x in zip(out, big))


CASES = {
    "resident": dict(device_data=True),
    "host": dict(device_data=False),
    "resident-h4w": dict(device_data=True, horizon=4, horizon_weights=(3.0, 1.0, 1.0, 1.0)),
    "shards": dict(device_data=True, device_shard_episodes=1, device_dtype="uint8"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_gde_matches_jax(case):
    """2 epochs over 2 episodes of 80 steps, batch 16, from JAX's init: the
    same split, shuffles and batches give JAX's history within rtol 1e-5
    (float32 sums in other orders), and JAX's final and best parameters
    within 1e-5. The best parameters are a copy, not the final ones."""
    jds, pds = _datasets()
    init = _jax_init()
    cfg = dict(TRAIN, **CASES[case])
    with jax.default_matmul_precision("highest"):
        want = jtrain.train_gde(jds, jtrain.GDETrainConfig(**cfg), verbose=False)
    got = ptrain.train_gde(pds, ptrain.GDETrainConfig(**cfg), verbose=False, device="cpu",
                           init_params=_as_state_dict(init))
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5, err_msg=k)
    assert got["history"]["train_loss"][1] < got["history"]["train_loss"][0]
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=1e-5)
    for key in ("final_params", "params"):
        ref = _as_state_dict(want[key])
        for n, v in got[key].items():
            np.testing.assert_allclose(v.numpy(), ref[n].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{key} {n}")
    model_params = dict(got["model"].named_parameters())
    for n, v in got["params"].items():
        assert v.data_ptr() != got["final_params"][n].data_ptr() != model_params[n].data_ptr()


def test_chunked_readback_gives_the_same_history():
    """epoch_scan_chunk only sets how often the loss is read back: 3
    batches at a time (a remainder chunk included) gives the history of
    one readback an epoch, to float32 summation order."""
    _, pds = _datasets()
    hist = [ptrain.train_gde(pds, ptrain.GDETrainConfig(**TRAIN, epoch_scan_chunk=c),
                             verbose=False, device="cpu")["history"] for c in (0, 3)]
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[1][k], hist[0][k], rtol=1e-6)


def test_best_params_are_a_copy_of_the_best_epoch():
    """`params` holds the best epoch's values, not the last one's: with a
    negative learning rate every step climbs the loss, so epoch 0 is the
    best of three, and `params` equals the final parameters of a one-epoch
    run bit for bit while `final_params` moved on. Changing the model
    afterwards does not reach them."""
    _, pds = _datasets()
    cfg = dict(batch_size=16, hidden_dim=HIDDEN, lr=-1e-3)
    one = ptrain.train_gde(pds, ptrain.GDETrainConfig(num_epochs=1, **cfg), verbose=False,
                           device="cpu")
    out = ptrain.train_gde(pds, ptrain.GDETrainConfig(num_epochs=3, **cfg), verbose=False,
                           device="cpu")
    hist = out["history"]["val_loss"]
    assert hist[0] < hist[1] < hist[2] and out["best_val_loss"] == hist[0]
    assert all(torch.equal(v, one["final_params"][k]) for k, v in out["params"].items())
    assert any(not torch.equal(v, out["final_params"][k]) for k, v in out["params"].items())
    kept = {k: v.clone() for k, v in out["params"].items()}
    with torch.no_grad():
        for p in out["model"].parameters():
            p.add_(1.0)
    assert all(torch.equal(kept[k], v) for k, v in out["params"].items())


def test_resume_matches_jax_and_restores_exactly(tmp_path):
    """Two epochs with checkpoints, then a resume to three: the resumed
    epoch matches JAX's resumed epoch (whose shuffles restart from the seed,
    as the port's do) within rtol 1e-5. A resume with nothing left to train
    gives back the saved parameters and optimizer state bit for bit."""
    jds, pds = _datasets()
    init = _jax_init()
    cfg = dict(TRAIN, checkpoint_every=1)
    got, want = [], []
    for epochs in (2, 3):
        with jax.default_matmul_precision("highest"):
            want.append(jtrain.train_gde(jds, jtrain.GDETrainConfig(
                **{**cfg, "num_epochs": epochs}, checkpoint_dir=str(tmp_path / "jax")),
                verbose=False))
        got.append(ptrain.train_gde(pds, ptrain.GDETrainConfig(
            **{**cfg, "num_epochs": epochs}, checkpoint_dir=str(tmp_path / "port")),
            verbose=False, device="cpu", init_params=_as_state_dict(init)))
    for k in ("train_loss", "val_loss"):
        assert len(got[1]["history"][k]) == 1
        np.testing.assert_allclose(got[1]["history"][k], want[1]["history"][k], rtol=1e-5)

    final = ptrain.train_gde(pds, ptrain.GDETrainConfig(**{**cfg, "num_epochs": 3},
                                                        checkpoint_dir=str(tmp_path / "port")),
                             verbose=False, device="cpu")
    assert final["history"]["train_loss"] == []
    assert all(torch.equal(v, got[1]["final_params"][k]) for k, v in final["final_params"].items())
    a, b = final["opt_state"], got[1]["opt_state"]
    assert torch.equal(a.count, b.count) and int(a.count) > 0
    assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))


def test_checkpoint_manager_contract(tmp_path):
    """save / latest_step / restore (full and partial) / max_to_keep /
    force, as the JAX class: tensors come back on the like's device in its
    dtype, numpy arrays as numpy, bit for bit."""
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore({"a": np.zeros(1)}) is None
    state = {"params": {"w": torch.randn(3, 2)}, "opt": [torch.tensor(3, dtype=torch.int32),
                                                         np.arange(4.0)], "epoch": 7}
    for step in (1, 5, 3):
        mgr.save(step, state)
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    with pytest.raises(FileExistsError):
        mgr.save(5, state)
    mgr.save(5, {**state, "epoch": 8}, force=True)
    like = {"params": {"w": torch.zeros(3, 2)}, "opt": [torch.zeros((), dtype=torch.int32),
                                                        np.zeros(4)], "epoch": 0}
    out = mgr.restore(like)
    assert out["epoch"] == 8 and torch.equal(out["params"]["w"], state["params"]["w"])
    assert out["opt"][0].dtype == torch.int32 and int(out["opt"][0]) == 3
    assert isinstance(out["opt"][1], np.ndarray) and np.array_equal(out["opt"][1], np.arange(4.0))
    assert mgr.restore({"epoch": 0}, step=3, partial=True) == {"epoch": 7}
    with pytest.raises(KeyError):
        mgr.restore({"epoch": 0})
    with pytest.raises(ValueError):
        mgr.restore({**like, "params": {"w": torch.zeros(2, 3)}})
    mgr.close()


def test_config_and_path_checks_match_jax():
    """GDETrainConfig has JAX's fields and defaults; horizon_weights of the
    wrong length or with horizon 1, and horizon > 1 without the resident
    path, raise ValueError as in the JAX trainer."""
    jf = {f.name: f.default for f in dataclasses.fields(jtrain.GDETrainConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(ptrain.GDETrainConfig)}
    assert pf == jf
    _, pds = _datasets(steps=20)
    for bad in (dict(horizon=3, horizon_weights=(1.0, 2.0)), dict(horizon=1, horizon_weights=(1.0,))):
        with pytest.raises(ValueError, match="horizon_weights"):
            ptrain.train_gde(pds, ptrain.GDETrainConfig(num_epochs=1, hidden_dim=4, **bad),
                             verbose=False, device="cpu")
    with pytest.raises(ValueError, match="device-resident"):
        ptrain.train_gde(pds, ptrain.GDETrainConfig(num_epochs=1, hidden_dim=4, horizon=2,
                                                    device_data=False),
                         verbose=False, device="cpu")


def test_train_gde_defaults_to_the_card():
    """device defaults to "cuda", with no fallback: without a card,
    train_gde raises (decided here, when the test runs)."""
    _, pds = _datasets(steps=20)
    cfg = ptrain.GDETrainConfig(num_epochs=1, batch_size=4, hidden_dim=4)
    if torch.cuda.is_available():
        out = ptrain.train_gde(pds, cfg, verbose=False)
        assert next(out["model"].parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ptrain.train_gde(pds, cfg, verbose=False)


def test_cli_trains_from_an_h5_file(tmp_path, monkeypatch, capsys):
    """python -m swarm_ode_tpu_torch.train.train_gde on a copy of a fixture
    (its sidecar cache is written beside the copy, in tmp_path): one epoch
    on the CPU, the best validation loss printed."""
    path = tmp_path / FIXTURES[0].name
    shutil.copy(FIXTURES[0], path)
    monkeypatch.chdir(tmp_path)
    ptrain.main(["--files", str(path), "--num_epochs", "1", "--max_episodes", "1",
                 "--hidden_dim", "8", "--device", "cpu", "--checkpoint_dir", "ck"])
    out = capsys.readouterr().out
    assert "Loaded 499 step pairs from 1 files (node dim 119; 3 AGVs, 2 Pickers)" in out
    assert "Best val loss:" in out and (tmp_path / "ck" / "0.pt").exists()
    assert list((tmp_path / "runs").glob("*.jsonl"))


def test_init_draws_as_flax_does():
    """GraphODE.init_: every kernel from lecun_normal (within two of its
    draw's standard deviations, sample std within 5% of sqrt(1/fan_in), as
    flax's init of the same model gives), biases zero; the draws follow
    the generator's seed."""
    model = GraphODE(435, 19, 9, 64)
    model.init_(torch.Generator().manual_seed(0))
    jmodel = JGraphODE(node_dim=435, num_agvs=19, num_pickers=9, hidden_dim=64)
    w = jt.TemporalWindow(obs=jnp.zeros((5, 28, 435)), count=jnp.int32(5))
    ref = _as_state_dict(jmodel.init(jax.random.PRNGKey(0), jt.build_temporal_graph(w, 19),
                                     jnp.array([0.0, 1.0])))
    assert set(ref) == set(model.state_dict())
    for name, v in model.state_dict().items():
        assert v.shape == ref[name].shape, name
        if name.endswith("bias"):
            assert not v.any(), name
            continue
        std = np.sqrt(1.0 / v.shape[1])
        assert float(v.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7, name
        assert abs(float(v.std()) / std - 1) < 0.05, name
        assert abs(float(ref[name].std()) / std - 1) < 0.05, name
    again = GraphODE(435, 19, 9, 64).init_(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))


def test_entry_matches_the_jax_entry():
    """entry(): the same example batch as __graft_entry__.entry (numpy from
    RandomState(0)), and, with the JAX entry's parameters converted, its
    forward within 1e-5 of JAX's at HIGHEST precision."""
    from swarm_ode_tpu_torch.entry import entry, example_batch

    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, (jparams, jobs, jcount) = graft.entry()
    fn, (params, obs, count) = entry("cpu")
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    jb = graft._example_graph_batch(8)
    pb = example_batch("cpu")
    for k in jb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
    assert set(params) == set(_as_state_dict(jparams))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jfn)(jparams, jobs, jcount))
    with torch.no_grad():
        got = fn(_as_state_dict(jparams), obs, count).numpy()
        own = fn(params, obs, count)
    assert got.shape == want.shape == (8, 5, 5, 2) and torch.isfinite(own).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
