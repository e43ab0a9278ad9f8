"""The port's GDE and its server against the JAX package.

Parameters cross over from a flax init (convert.gde_params_from_numpy), or
from the flagship's exported blob (results_data/gde_medium_h4w.stablehlo,
read by torch_port_helpers.gde_params_from_stablehlo), whose predictions
the port's server must reproduce.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.graphs import temporal as jt
from swarm_ode_tpu.models.gde import GraphODE as JGraphODE
from swarm_ode_tpu.serving import load_gde
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.graphs import temporal as pt
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.serving import make_gde_fn
from torch_port_helpers import gde_params_from_stablehlo, served_windows

BLOB = pathlib.Path(__file__).resolve().parent.parent / "results_data" / "gde_medium_h4w.stablehlo"


def _rand_batch(rng, B=3, W=4, N=5, D=11):
    """As tests/test_gde_batched.py draws its batches."""
    obs = rng.rand(B, W, N, D).astype(np.float32) * 10.0
    count = rng.randint(1, W + 1, size=(B,)).astype(np.int32)
    obs = obs * (np.arange(W)[None, :] < count[:, None])[:, :, None, None]
    return obs, count


def _models(solver, D=11, hidden=8, num_agvs=2):
    jmodel = JGraphODE(node_dim=D, num_agvs=num_agvs, hidden_dim=hidden, ode_solver=solver)
    return jmodel, GraphODE(node_dim=D, num_agvs=num_agvs, hidden_dim=hidden, ode_solver=solver)


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_apply_and_apply_batched_match_jax(solver):
    """At tests/test_gde_batched.py:78-79's tolerances (rtol 1e-4, atol 1e-5)."""
    obs, count = _rand_batch(np.random.RandomState(1))
    B, W, N, _ = obs.shape
    jmodel, model = _models(solver)
    t_span = jnp.array([0.0, 1.0, 2.0], jnp.float32)
    jgraphs = jax.vmap(lambda o, c: jt.build_temporal_graph(jt.TemporalWindow(o, c), 2))(
        jnp.asarray(obs), jnp.asarray(count))
    params = jmodel.init(jax.random.PRNGKey(0), jax.tree.map(lambda a: a[0], jgraphs), t_span)
    model.load_state_dict(
        convert.gde_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"))
    ref = np.asarray(jax.vmap(lambda g: jmodel.apply(params, g, t_span)["trajectories"])(jgraphs))
    ref_b = np.asarray(jmodel.apply_batched(
        params, jt.build_temporal_batch(jnp.asarray(obs), jnp.asarray(count), 2), t_span
    )["trajectories"])

    po, pc, pt_span = torch.from_numpy(obs), torch.from_numpy(count), torch.tensor([0.0, 1.0, 2.0])
    with torch.no_grad():
        dense = model.apply(pt.build_temporal_graph(pt.TemporalWindow(po, pc), 2), pt_span)
        bg = pt.build_temporal_batch(po, pc, 2)
        structured = model.apply_batched(bg, pt_span)["trajectories"]
        sparse = model.apply_batched(bg, pt_span, edges=pt.temporal_edges(bg))["trajectories"]
    tol = dict(rtol=1e-4, atol=1e-5)
    # JAX: (B, T, W*N, 2) from vmap; port: (T, B, W*N, 2).
    np.testing.assert_allclose(dense["trajectories"].numpy(), ref.swapaxes(0, 1), **tol)
    np.testing.assert_allclose(structured.numpy(), ref_b, **tol)
    np.testing.assert_allclose(sparse.numpy(), ref_b, **tol)
    np.testing.assert_allclose(structured.numpy().reshape(dense["trajectories"].shape),
                               dense["trajectories"].numpy(), **tol)
    assert dense["node_features"].shape == (3, B, W * N, 11)


def test_params_round_trip():
    jmodel, model = _models("euler")
    g = jt.build_temporal_graph(jt.init_window(4, 5, 11), 2)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3), g, jnp.arange(2.0)))
    sd = convert.gde_params_from_numpy(tree, device="cpu")
    assert set(sd) == set(model.state_dict())
    back = convert.gde_params_to_numpy(sd)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


def test_flagship_blob_predictions_match():
    """The port's server, with the weights read out of the flagship blob,
    against the blob itself (jax.export, the dense per-window path) on the
    port's own medium windows. 1e-4 absolute (2.9e-5 measured on the CPU):
    float32 sums over 435-wide rows of inputs up to 24, in another order,
    on predicted positions up to ~30 (float32 spacing 1.9e-6 there)."""
    w = served_windows()
    assert w.obs.shape == (3, 5, 28, 435) and w.count.tolist() == [5, 3, 1]
    model = GraphODE(node_dim=435, num_agvs=19, num_pickers=9, hidden_dim=64, ode_solver="euler")
    params = convert.gde_params_from_numpy(gde_params_from_stablehlo(BLOB), device="cpu")
    predict = make_gde_fn(model, params, distance_threshold=5.0, horizon=4)
    blob = load_gde(BLOB.read_bytes())
    batch = predict(w.obs, w.count)
    assert batch.shape == (3, 5, 28, 2)
    for b in range(3):
        ref = np.asarray(blob(w.obs[b].numpy(), w.count[b].numpy()))
        one = predict(w.obs[b], w.count[b])
        assert one.shape == ref.shape == (5, 28, 2)
        np.testing.assert_allclose(one.numpy(), ref, rtol=0, atol=1e-4)
        np.testing.assert_allclose(batch[b].numpy(), ref, rtol=0, atol=1e-4)
        # t = 0 is the decoded observation itself, and the trajectory moves.
        assert np.abs(ref[1:] - ref[:1]).max() > 1e-3
