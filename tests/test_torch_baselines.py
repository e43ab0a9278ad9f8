"""The trajectory baselines' trainer in the port against the JAX package's,
on the CPU, JAX at HIGHEST matmul precision.

The data are the committed tiny fixtures (tarware-tiny-3agvs-2pickers, 5
agents x 119 features), decoded with cache=False so that nothing under
tests/fixtures/ is written; the models are narrow (hidden 16). The port
starts from the JAX model's own init, converted
(convert.flax_params_to_state_dict). Tolerances are stated per test."""
import dataclasses
import functools
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swarm_ode_tpu.data.dataset import TrajectoryDataset as JDataset
from swarm_ode_tpu.train import train_baselines as jtb
from swarm_ode_tpu.train import train_gde as jtrain
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
from swarm_ode_tpu_torch.train import train_baselines as ptb
from swarm_ode_tpu_torch.train import train_gde as ptrain
from swarm_ode_tpu_torch.utils.optim import adamw_init

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = sorted((REPO / "tests" / "fixtures" / "datasets").glob("*.h5"))
HIDDEN, STEPS = 16, 80
TRAIN = dict(num_epochs=2, batch_size=16, hidden_dim=HIDDEN)
HIGHEST = jax.default_matmul_precision("highest")


@functools.lru_cache(maxsize=None)
def _datasets(steps=STEPS):
    """The JAX and port datasets of the first fixture's 2 episodes cut to
    `steps` steps."""
    eps, na, npk = TrajectoryDataset._load_file(str(FIXTURES[0]), cache=False, limit=2)
    eps = [np.asarray(e[:steps], np.float32) for e in eps]
    return (JDataset(episodes=eps, num_agvs=na, num_pickers=npk, seq_len=5),
            TrajectoryDataset(episodes=eps, num_agvs=na, num_pickers=npk, seq_len=5))


@functools.lru_cache(maxsize=None)
def _jax_init(model):
    """The JAX trainer's own init for `model` (PRNGKey(seed) on its sample
    window): a run of 0 epochs returns it."""
    jds, _ = _datasets()
    cfg = jtb.BaselineTrainConfig(model=model, **{**TRAIN, "num_epochs": 0})
    return jtb.train_baseline(jds, cfg, verbose=False)["params"]


def _sd(tree):
    return convert.flax_params_to_state_dict(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_extract_windows_with_pos_matches_jax(horizon, dtype):
    """Every window of two episodes cut with with_pos=True (observations,
    count, next positions, the window's positions; no hweight even at
    horizon 4) equals the JAX package's cut, bit for bit."""
    jds, pds = _datasets()
    jeps, jdt = jtrain.stack_episodes_streamed(jds.episodes, dtype)
    peps, pdt = ptrain.stack_episodes_streamed(pds.episodes, dtype)
    pos = np.stack(jds._positions)
    if horizon > 1:
        pos = np.pad(pos, ((0, 0), (0, horizon), (0, 0), (0, 0)), mode="edge")
    pairs = np.asarray(jds._index, np.int32)
    want = jtrain._extract_windows(jnp.asarray(jeps, jdt), jnp.asarray(pos), 5,
                                   jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]),
                                   with_pos=True, horizon=horizon, true_len=STEPS)
    got = ptrain._extract_windows(torch.from_numpy(peps).to(pdt), torch.from_numpy(pos), 5,
                                  torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1]),
                                  with_pos=True, horizon=horizon, true_len=STEPS)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The window's positions are the dataset's own (host) windows.
    host = pds.batch(np.arange(len(pds)))
    np.testing.assert_array_equal(got[3].numpy(), host["pos"])


@pytest.mark.parametrize("model", ["gru", "pos_lstm"])
def test_baseline_step_matches_jax(model):
    """One train step (loss, gradient, clip, AdamW) on resident windows,
    one of weight 0: the loss within 1e-5, every gradient element within
    1e-5 of its gradient's largest, the parameters after AdamW within
    1e-6."""
    jds, pds = _datasets()
    params = _jax_init(model)
    position_only = model.startswith("pos_")
    pairs = np.array([[0, 0], [0, 1], [1, 2], [0, 40], [1, 61], [0, STEPS - 2], [1, 33]],
                     np.int32)
    pos = np.stack(jds._positions)
    cut = jtrain._extract_windows(jnp.asarray(np.stack(jds.episodes)), jnp.asarray(pos), 5,
                                  jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1]),
                                  with_pos=True)
    batch = dict(zip(("obs", "count", "next_pos", "pos"), (np.array(c) for c in cut)))
    batch["weight"] = np.ones(len(pairs), np.float32)
    batch["weight"][1] = 0.0

    jmodel = jtb.MODEL_FACTORIES[model](jds, HIDDEN)
    cfg = ptb.BaselineTrainConfig(model=model, hidden_dim=HIDDEN, device="cpu")

    def jloss(p, b):
        pred = jmodel.apply(p, b["pos"] if position_only else b["obs"])
        per = jnp.mean((pred - b["next_pos"]) ** 2, axis=(1, 2))
        return jnp.sum(per * b["weight"]) / jnp.maximum(jnp.sum(b["weight"]), 1.0)

    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adamw(cfg.lr, weight_decay=cfg.weight_decay))
    with HIGHEST:
        ref, gref = jax.value_and_grad(jloss)(params, jax.tree.map(jnp.asarray, batch))
        upd, _ = tx.update(gref, tx.init(params), params)
        new_ref = _sd(optax.apply_updates(params, upd))

    pmodel = ptb.MODEL_FACTORIES[model](pds, HIDDEN)
    pmodel.load_state_dict(_sd(params))
    loss_fn = ptb.baseline_loss(pmodel, position_only)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    plist = list(pmodel.parameters())
    grads = torch.autograd.grad(loss_fn(pbatch), plist)
    names = [n for n, _ in pmodel.named_parameters()]
    _, loss = ptrain.train_step(plist, adamw_init(plist), loss_fn, pbatch, cfg)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    for name, g in zip(names, grads):
        want = _sd(gref)[name].numpy()
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_ref[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


CASES = {
    "gru": dict(model="gru"),
    "lstm": dict(model="lstm"),
    "pos_gru": dict(model="pos_gru", device_dtype="uint8"),
    "pos_lstm": dict(model="pos_lstm"),
    "gru-host": dict(model="gru", device_data=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_baseline_matches_jax(case):
    """2 epochs over 2 episodes of 80 steps, batch 16, from JAX's init:
    the same split, shuffles and batches give JAX's history within rtol
    1e-5, and JAX's best parameters within 1e-5 (a copy, not the final
    ones)."""
    jds, pds = _datasets()
    cfg = dict(TRAIN, **CASES[case])
    with HIGHEST:
        want = jtb.train_baseline(jds, jtb.BaselineTrainConfig(**cfg), verbose=False)
    got = ptb.train_baseline(pds, ptb.BaselineTrainConfig(**cfg, device="cpu"), verbose=False,
                             init_params=_sd(_jax_init(cfg["model"])))
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][k], want["history"][k], rtol=1e-5, err_msg=k)
    assert got["history"]["train_loss"][1] < got["history"]["train_loss"][0]
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=1e-5)
    ref = _sd(want["params"])
    for n, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), ref[n].numpy(), rtol=0, atol=1e-5, err_msg=n)
    model_params = dict(got["model"].named_parameters())
    for n, v in got["params"].items():
        assert v.data_ptr() != model_params[n].data_ptr()


def test_resident_and_host_paths_agree():
    """The resident path (windows cut on the device, uint8 storage) and the
    host path (the dataset's windows) take the same steps: histories and
    parameters within float32 summation order (1e-6), as JAX's own paths
    agree (tests/test_train_paths.py)."""
    _, pds = _datasets()
    init = _sd(_jax_init("lstm"))
    outs = [ptb.train_baseline(pds, ptb.BaselineTrainConfig(model="lstm", **TRAIN, device="cpu",
                                                             **kw), verbose=False,
                               init_params=init)
            for kw in (dict(device_dtype="uint8"), dict(device_data=False))]
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(outs[0]["history"][k], outs[1]["history"][k], rtol=1e-6)
    for n, v in outs[0]["final_params"].items():
        np.testing.assert_allclose(v.numpy(), outs[1]["final_params"][n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_short_validation_split_is_one_host_batch():
    """A validation split shorter than a batch is evaluated as one short
    batch, on both paths, as in JAX (train_baselines.py:229-240)."""
    jds, pds = _datasets(steps=40)
    cfg = dict(model="pos_gru", num_epochs=1, batch_size=16, hidden_dim=8)
    init = jtb.train_baseline(jds, jtb.BaselineTrainConfig(**{**cfg, "num_epochs": 0}),
                              verbose=False)["params"]
    with HIGHEST:
        want = jtb.train_baseline(jds, jtb.BaselineTrainConfig(**cfg), verbose=False)
    for dd in (True, False):
        got = ptb.train_baseline(pds, ptb.BaselineTrainConfig(**cfg, device_data=dd,
                                                              device="cpu"),
                                 verbose=False, init_params=_sd(init))
        np.testing.assert_allclose(got["history"]["val_loss"], want["history"]["val_loss"],
                                   rtol=1e-5)


def test_config_matches_jax():
    """BaselineTrainConfig has JAX's fields and defaults, plus the device
    (the card by default); MODEL_FACTORIES the same four models."""
    jf = {f.name: f.default for f in dataclasses.fields(jtb.BaselineTrainConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(ptb.BaselineTrainConfig)}
    assert pf.pop("device") == "cuda"
    assert pf == jf
    assert list(ptb.MODEL_FACTORIES) == list(jtb.MODEL_FACTORIES)


def test_train_baseline_defaults_to_the_card():
    """device defaults to "cuda", with no fallback: without a card,
    train_baseline raises (decided here, when the test runs)."""
    _, pds = _datasets()
    cfg = ptb.BaselineTrainConfig(num_epochs=1, batch_size=4, hidden_dim=4)
    if torch.cuda.is_available():
        out = ptb.train_baseline(pds, cfg, verbose=False)
        assert next(out["model"].parameters()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ptb.train_baseline(pds, cfg, verbose=False)


def test_cli_trains_from_an_h5_file(tmp_path, monkeypatch, capsys):
    """python -m swarm_ode_tpu_torch.train.train_baselines on a copy of a
    fixture (its sidecar cache is written beside the copy, in tmp_path):
    one epoch of two models on the CPU, each best validation loss printed."""
    path = tmp_path / FIXTURES[0].name
    shutil.copy(FIXTURES[0], path)
    monkeypatch.chdir(tmp_path)
    ptb.main(["--files", str(path), "--num_epochs", "1", "--max_episodes", "1",
              "--hidden_dim", "8", "--models", "gru", "pos_lstm", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[gru] Epoch   0" in out and "[gru] best val loss:" in out
    assert "[pos_lstm] best val loss:" in out
