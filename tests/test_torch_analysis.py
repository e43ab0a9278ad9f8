"""The port's analysis.py (metric suite, evaluate_gde, evaluate_baseline,
the evaluation CLI) against the JAX package's, on the CPU.

The metric functions take numpy inputs made from a seed, predictions being
the targets plus seeded noise so that every success rate and the collision
F1 lie strictly between 0 and 1; the two packages must return the same
values. The evaluators run on the committed tiny fixture
(tarware-tiny-3agvs-2pickers, 5 agents x 119 features), decoded with
cache=False (or copied under tmp_path) so that nothing under
tests/fixtures/ is written, with JAX's models (hidden 16) trained a few
epochs by the JAX trainers and carried into the port's
(convert.gde_params_from_numpy, flax_params_to_state_dict); JAX runs at
HIGHEST matmul precision. Predictions agree within 1e-5 of the largest,
the continuous metrics within 1e-5 relative; a success rate may differ
only by the predictions whose error lies within that tolerance of its
threshold, and the collision flags only on pairs whose distance lies
within it of 1.5.
"""
import functools
import json
import pathlib
import shutil

import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu import analysis as janalysis
from swarm_ode_tpu.data.dataset import TrajectoryDataset as JDataset
from swarm_ode_tpu.train import train_baselines as jtb
from swarm_ode_tpu.train import train_gde as jtrain
from swarm_ode_tpu_torch import analysis
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
from swarm_ode_tpu_torch.models import gde as gde_mod
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.train import train_baselines as ptb
from swarm_ode_tpu_torch.train import train_gde as ptrain

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = next((REPO / "tests" / "fixtures" / "datasets").glob("*tiny*seed4000.h5"))
HIDDEN, STEPS, EPOCHS = 16, 120, 10
HIGHEST = jax.default_matmul_precision("highest")
PRED_RTOL, METRIC_RTOL = 1e-5, 1e-5
CONTINUOUS = ("mean_error", "median_error", "max_error", "std_error", "rmse")
THRESHOLDS = (0.5, 1.0, 1.5, 2.0)


# --- (a) the metric suite -------------------------------------------------

def _noisy(shape, seed, scale=0.8):
    """(pred, target): targets on the integer cells of an 8 x 8 grid, the
    predictions those plus Gaussian noise, float32 as the evaluators give."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 8, shape).astype(np.float32)
    pred = (target + rng.normal(0.0, scale, shape)).astype(np.float32)
    return pred, target


def _walk(T, N, seed):
    """(T, N, 2) trajectories of unit moves, some agents standing still."""
    rng = np.random.default_rng(seed)
    moves = rng.integers(-1, 2, (T - 1, N, 2)) * (rng.random((T - 1, N, 1)) < 0.7)
    return np.concatenate([rng.integers(0, 10, (1, N, 2)), moves]).cumsum(0).astype(np.float32)


def _multi_step(m):
    obs = _walk(30, 5, 7)
    obs = np.concatenate([obs, np.ones((30, 5, 3), np.float32)], axis=-1)  # (T, N, D)
    w = np.array([0.5, 0.3, 0.2], np.float32)

    def predict_fn(window):  # (W, N, D) -> (N, 2): a weighted look back
        return np.tensordot(w, window[-3:, :, :2], axes=1) + 0.25

    return m.multi_step_prediction_error(predict_fn, obs, obs[..., :2], horizon=3, seq_len=5)


def _direction(m, still=False):
    pred, target = _noisy((40, 5, 2), 3)
    prev = target - np.random.default_rng(4).integers(-1, 2, (40, 5, 2)).astype(np.float32)
    if still:
        return m.direction_error_metrics(prev, target, prev)
    return m.direction_error_metrics(pred, target, prev)


METRICS = {
    "position_error_metrics": lambda m: m.position_error_metrics(*_noisy((64, 5, 2), 0)),
    "direction_error_metrics": lambda m: _direction(m),
    "direction_error_metrics, nothing moved": lambda m: _direction(m, still=True),
    "success_rates": lambda m: m.success_rates(*_noisy((64, 5, 2), 1)),
    "success_rates, own thresholds": lambda m: m.success_rates(*_noisy((64, 5, 2), 1),
                                                               thresholds=(0.25, 3.0)),
    "multi_step_prediction_error": _multi_step,
    "collision_prediction_metrics, (T, N, 2)": lambda m: m.collision_prediction_metrics(
        *_noisy((40, 5, 2), 2)),
    "collision_prediction_metrics, pred[None]": lambda m: m.collision_prediction_metrics(
        *(x[None] for x in _noisy((40, 5, 2), 2))),
    "hausdorff_distance": lambda m: m.hausdorff_distance(_walk(30, 1, 5)[:, 0],
                                                         _walk(25, 1, 6)[:, 0]),
    "dtw_distance": lambda m: m.dtw_distance(_walk(30, 1, 5)[:, 0], _walk(25, 1, 6)[:, 0]),
    "trajectory_shape_metrics": lambda m: m.trajectory_shape_metrics(*_noisy((30, 5, 2), 8)),
    "spatial_density": lambda m: m.spatial_density(_walk(50, 5, 9), (12, 14)),
    "spatial_density, counts": lambda m: m.spatial_density(_walk(50, 5, 9), (12, 14),
                                                           normalize=False),
    "trajectory_statistics": lambda m: m.trajectory_statistics(_walk(50, 5, 10)),
}


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_matches_jax(case):
    """Each metric function of the port gives the JAX function's result on
    the same seeded inputs: the same keys, values and types (arrays equal
    in value and dtype)."""
    want, got = METRICS[case](janalysis), METRICS[case](analysis)
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return
    assert got == want
    if isinstance(want, dict):
        assert all(type(got[k]) is type(want[k]) for k in want)
    rates = {k: v for k, v in got.items() if k.startswith(("success", "collision_f1"))} \
        if isinstance(got, dict) else {}
    assert all(0.0 < v < 1.0 for v in rates.values()), rates


def test_collision_metric_as_the_evaluators_call_it_pairs_windows():
    """The evaluators' call, collision_prediction_metrics(pred[None],
    target[None]) on (windows, N, 2), pairs one agent slot across two
    windows, not two agents of one window; the port keeps JAX's call, so
    on the seeded inputs above the two calls give different F1s in both
    packages."""
    near = np.array([[[0.0, 0.0], [0.0, 1.0]], [[10.0, 10.0], [20.0, 20.0]]], np.float32)
    for m in (janalysis, analysis):
        assert m.collision_prediction_metrics(near, near)["collision_recall"] == 1.0
        assert m.collision_prediction_metrics(near[None], near[None])["collision_recall"] == 0.0
    pred, target = _noisy((40, 5, 2), 2)
    documented = analysis.collision_prediction_metrics(pred, target)["collision_f1"]
    as_called = analysis.prediction_metrics(pred, target)["collision_f1"]
    assert as_called == janalysis.collision_prediction_metrics(pred[None], target[None])[
        "collision_f1"]
    assert round(documented, 4) == 0.6265 and round(as_called, 4) == 0.5278


# --- (b), (c) the evaluators ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _episodes(steps=STEPS, n=2):
    eps, na, npk = TrajectoryDataset._load_file(str(FIXTURE), cache=False, limit=n)
    return [np.asarray(e[:steps], np.float32) for e in eps], na, npk


def _datasets(eps=None):
    full, na, npk = _episodes()
    eps = full if eps is None else eps
    return (JDataset(episodes=eps, num_agvs=na, num_pickers=npk, seq_len=5),
            TrajectoryDataset(episodes=eps, num_agvs=na, num_pickers=npk, seq_len=5))


@functools.lru_cache(maxsize=None)
def _jax_gde():
    """JAX's GDE trained EPOCHS epochs by JAX's trainer on _datasets(), and
    its parameters as the port's state dict."""
    jds, _ = _datasets()
    out = jtrain.train_gde(jds, jtrain.GDETrainConfig(num_epochs=EPOCHS, batch_size=16,
                                                      hidden_dim=HIDDEN), verbose=False)
    tree = jax.tree.map(np.asarray, out["params"])
    return out["model"], out["params"], convert.gde_params_from_numpy(tree, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_baseline(model):
    jds, _ = _datasets()
    cfg = jtb.BaselineTrainConfig(model=model, num_epochs=3, batch_size=16, hidden_dim=HIDDEN)
    out = jtb.train_baseline(jds, cfg, verbose=False)
    tree = jax.tree.map(np.asarray, out["params"])
    return out["model"], out["params"], convert.flax_params_to_state_dict(tree, device="cpu")


def _jax_eval(monkeypatch, fn, *args, **kw):
    """JAX's metrics and the predictions and targets its evaluation loop computed
    them from (recorded at its success_rates call)."""
    seen = []
    real = janalysis.success_rates

    def spy(pred, target, *a, **k):
        seen.append((np.array(pred), np.array(target)))
        return real(pred, target, *a, **k)

    monkeypatch.setattr(janalysis, "success_rates", spy)
    with HIGHEST:
        out = fn(*args, **kw)
    monkeypatch.undo()
    return out, *seen[0]


def _pair_distances(pos):
    """The collision metrics' pair distances of (1, windows, N, 2) input."""
    d = np.linalg.norm(pos[:, :, None, :] - pos[:, None, :, :], axis=-1)
    iu = np.triu_indices(pos.shape[1], k=1)
    return d[:, iu[0], iu[1]].reshape(-1)


def assert_metrics_agree(got, want, pred, want_pred, target, want_target):
    """The tolerances of the module docstring, port (got) against JAX."""
    np.testing.assert_array_equal(target, want_target)
    tol = PRED_RTOL * max(1.0, float(np.abs(want_pred).max()))
    assert float(np.abs(pred - want_pred).max()) <= tol
    assert list(got) == list(want)
    for k in CONTINUOUS:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    err = np.linalg.norm(want_pred - target, axis=-1).reshape(-1)
    for t in THRESHOLDS:
        slack = np.sum(np.abs(err - t) <= 2 * tol) / err.size
        assert abs(got[f"success_rate@{t}"] - want[f"success_rate@{t}"]) <= slack, t
    d_got, d_want = _pair_distances(pred[None]), _pair_distances(want_pred[None])
    differ = (d_got < 1.5) != (d_want < 1.5)
    assert np.all(np.abs(d_want[differ] - 1.5) <= 4 * tol)
    collision = janalysis.collision_prediction_metrics(pred[None], target[None])
    assert {k: got[k] for k in collision} == collision
    if not differ.any():
        assert collision == {k: want[k] for k in collision}


GDE_CASES = {
    "every window, batch 64": dict(indices=None, batch_size=64),
    "strided windows, batch 16": dict(indices=range(3, 230, 3), batch_size=16),
}


@pytest.mark.parametrize("case", sorted(GDE_CASES))
def test_evaluate_gde_matches_jax(case, monkeypatch):
    """evaluate_gde on the CPU against JAX's with JAX's trained weights: the
    metrics agree within the stated tolerances, and the success rates and
    the collision F1 lie strictly between 0 and 1."""
    jds, pds = _datasets()
    jmodel, jparams, sd = _jax_gde()
    kw = GDE_CASES[case]
    want, want_pred, want_target = _jax_eval(monkeypatch, janalysis.evaluate_gde, jmodel,
                                             jparams, jds, **kw)
    model = GraphODE(pds.obs_dim, pds.num_agvs, pds.num_pickers, HIDDEN)
    got = analysis.evaluate_gde(model, sd, pds, device="cpu", **kw)
    pred, target = analysis.predict_windows(
        analysis.gde_predictor(model, sd, pds.num_agvs, device="cpu"), pds, kw["indices"],
        kw["batch_size"], device="cpu")
    assert_metrics_agree(got, want, pred, want_pred, target, want_target)
    rates = [got[f"success_rate@{t}"] for t in THRESHOLDS] + [got["collision_f1"]]
    assert all(0.0 < r < 1.0 for r in rates), rates


def test_evaluate_gde_on_episodes_of_unequal_length(monkeypatch):
    """Episodes of 120, 37 and 4 steps (shorter than the window): the
    device cut zero-pads them to one length and gives JAX's windows."""
    full, _, _ = _episodes()
    jds, pds = _datasets([full[0], full[1][:37], full[1][40:44]])
    jmodel, jparams, sd = _jax_gde()
    want, want_pred, want_target = _jax_eval(monkeypatch, janalysis.evaluate_gde, jmodel,
                                             jparams, jds, batch_size=32)
    model = GraphODE(pds.obs_dim, pds.num_agvs, pds.num_pickers, HIDDEN)
    got = analysis.evaluate_gde(model, sd, pds, batch_size=32, device="cpu")
    pred, target = analysis.predict_windows(
        analysis.gde_predictor(model, sd, pds.num_agvs, device="cpu"), pds, batch_size=32,
        device="cpu")
    assert_metrics_agree(got, want, pred, want_pred, target, want_target)


def test_evaluate_gde_plans_once_per_batch_and_takes_the_datasets_agvs(monkeypatch):
    """A model built as the JAX CLI builds it (num_agvs = 0) is scored on
    graphs of the dataset's AGVs, as JAX's evaluate_gde does; every batch,
    the short tail too, plans its edges once; the caller's model is not
    moved or changed."""
    _, pds = _datasets()
    _, _, sd = _jax_gde()
    plans = []
    real = gde_mod.segment_plan
    monkeypatch.setattr(gde_mod, "segment_plan", lambda *a, **k: plans.append(1) or real(*a, **k))
    bare = GraphODE(pds.obs_dim, hidden_dim=HIDDEN)
    before = {k: v.clone() for k, v in bare.state_dict().items()}
    got = analysis.evaluate_gde(bare, sd, pds, indices=range(100), batch_size=32, device="cpu")
    assert len(plans) == 4  # 32 + 32 + 32 + 4
    assert all(torch.equal(v, before[k]) for k, v in bare.state_dict().items())
    model = GraphODE(pds.obs_dim, pds.num_agvs, pds.num_pickers, HIDDEN)
    assert got == analysis.evaluate_gde(model, sd, pds, indices=range(100), batch_size=32,
                                        device="cpu")
    wrong = analysis.gde_predictor(model, sd, 0, device="cpu")
    assert got != analysis._evaluate_predictor(wrong, pds, range(100), 32, device="cpu")


@pytest.mark.parametrize("name", sorted(ptb.MODEL_FACTORIES))
def test_evaluate_baseline_matches_jax(name, monkeypatch):
    """evaluate_baseline for each of the four baselines (position_only for
    the position models), JAX's weights after 3 epochs, 150 windows in
    batches of 64: the metrics agree within the stated tolerances."""
    jds, pds = _datasets()
    jmodel, jparams, sd = _jax_baseline(name)
    pos = name.startswith("pos_")
    kw = dict(position_only=pos, indices=range(150), batch_size=64)
    want, want_pred, want_target = _jax_eval(monkeypatch, janalysis.evaluate_baseline, jmodel,
                                             jparams, jds, **kw)
    model = ptb.MODEL_FACTORIES[name](pds, HIDDEN)
    got = analysis.evaluate_baseline(model, sd, pds, device="cpu", **kw)
    pred, target = analysis.predict_windows(
        analysis.baseline_predictor(model, sd, pos, device="cpu"), pds, range(150), 64,
        device="cpu", with_pos=pos)
    assert_metrics_agree(got, want, pred, want_pred, target, want_target)


def test_evaluators_run_on_the_card_by_default():
    """Without device="cpu" the evaluators put the windows on the card:
    with no card they raise rather than fall back to the CPU."""
    _, pds = _datasets()
    _, _, sd = _jax_gde()
    model = GraphODE(pds.obs_dim, pds.num_agvs, pds.num_pickers, HIDDEN)
    if torch.cuda.is_available():
        assert np.isfinite(analysis.evaluate_gde(model, sd, pds, range(8))["mean_error"])
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            analysis.evaluate_gde(model, sd, pds, range(8))


# --- (d) the CLI ----------------------------------------------------------

def test_results_cli_prints_evaluate_gde_of_the_checkpoint(tmp_path, capsys):
    """`analysis results --device cpu` on a checkpoint the port's train_gde
    wrote prints evaluate_gde's dict of those weights, rounded to 5
    places."""
    h5 = tmp_path / FIXTURE.name
    shutil.copy(FIXTURE, h5)
    ds = TrajectoryDataset.from_h5([str(h5)], max_episodes=1)
    cfg = ptrain.GDETrainConfig(num_epochs=1, batch_size=32, hidden_dim=HIDDEN,
                                checkpoint_dir=str(tmp_path / "ckpt"))
    out = ptrain.train_gde(ds, cfg, verbose=False, device="cpu")
    analysis.main(["results", "--files", str(h5), "--checkpoint_dir", str(tmp_path / "ckpt"),
                   "--hidden_dim", str(HIDDEN), "--max_episodes", "1", "--max_windows", "150",
                   "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    want = analysis.evaluate_gde(out["model"], out["final_params"], ds, range(150),
                                 device="cpu")
    assert printed == {k: round(v, 5) for k, v in want.items()}


def test_results_cli_without_a_checkpoint_exits(tmp_path):
    h5 = tmp_path / FIXTURE.name
    shutil.copy(FIXTURE, h5)
    with pytest.raises(SystemExit, match="No checkpoint found"):
        analysis.main(["results", "--files", str(h5), "--checkpoint_dir", str(tmp_path / "no"),
                       "--max_episodes", "1", "--device", "cpu"])


def test_dataset_cli_matches_jax(tmp_path, capsys):
    """`analysis dataset` prints scripts/analyze_dataset.py's statistics
    (JAX's trajectory_statistics over JAX's reading of the file) and
    writes the density heatmap it is asked for."""
    h5 = tmp_path / FIXTURE.name
    shutil.copy(FIXTURE, h5)
    png = tmp_path / "density.png"
    analysis.main(["dataset", "--files", str(h5), "--max_episodes", "2",
                   "--heatmap_out", str(png)])
    text = capsys.readouterr().out
    printed = json.loads(text[: text.rindex("}") + 1])
    jds = JDataset.from_h5([str(h5)], max_episodes=2)
    from swarm_ode_tpu.data.dataset import extract_positions_np

    per_ep = [janalysis.trajectory_statistics(extract_positions_np(ep, jds.num_agvs))
              for ep in jds.episodes]
    want = {k: float(np.mean([s[k] for s in per_ep])) for k in per_ep[0]}
    want.update(episodes=2, steps_per_episode=int(jds.episodes[0].shape[0]))
    assert printed == want
    assert png.stat().st_size > 0 and f"saved {png}" in text


# --- (e) the pipeline -----------------------------------------------------

def test_pipeline_collect_train_evaluate(tmp_path):
    """The port's datagen -> HDF5 -> dataset -> train_gde -> evaluate_gde in
    miniature on the CPU (tests/test_pipeline_integration.py's steps, at
    hidden 16 and 2 epochs): the loss falls and the metrics are finite."""
    from swarm_ode_tpu_torch.data.collect import collect_data

    h5 = str(tmp_path / "tiny.h5")
    stats = collect_data("tarware-tiny-3agvs-2pickers-partialobs-v1", num_episodes=2, seed=0,
                         out_path=h5, batch=2, chunk=100, verbose=False, device="cpu")
    assert stats["episodes"] == 2
    ds = TrajectoryDataset.from_h5([h5], seq_len=5)
    assert len(ds) == 2 * 499
    ds.episodes = [ds.episodes[0][:80], ds.episodes[1][:80]]
    ds.__post_init__()
    out = ptrain.train_gde(ds, ptrain.GDETrainConfig(num_epochs=2, batch_size=16,
                                                     hidden_dim=HIDDEN),
                           verbose=False, device="cpu")
    h = out["history"]
    assert h["train_loss"][-1] < h["train_loss"][0]
    metrics = analysis.evaluate_gde(out["model"], out["params"], ds, indices=range(0, 60, 4),
                                    device="cpu")
    assert set(metrics) >= {"mean_error", "success_rate@2.0", "collision_f1"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert 0.0 <= metrics["success_rate@2.0"] <= 1.0
