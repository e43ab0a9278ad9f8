"""The port's odeint (forward) against the JAX package's, and dopri5 against
the closed-form fixture.

Each solver runs the same problem in both packages: a linear system and a
small GDE vector field (converted flax parameters on a temporal graph).
1e-5 absolute on states of unit scale: float32 arithmetic in the same order
up to the matrix products' sums.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.graphs import temporal as jt
from swarm_ode_tpu.models.gde import GraphODE as JGraphODE
from swarm_ode_tpu.ops.odeint import odeint as jodeint
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.ops.odeint import odeint

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "parity_fixtures.npz"
SOLVERS = [("euler", 1), ("euler", 3), ("midpoint", 1), ("midpoint", 3), ("rk4", 1),
           ("rk4", 3), ("dopri5", 1)]
T_SPAN = np.array([0.0, 0.5, 1.0, 2.5], np.float32)


def _linear_system():
    rng = np.random.RandomState(0)
    A = (-0.5 * np.eye(6) + 0.3 * rng.randn(6, 6)).astype(np.float32)
    y0 = rng.randn(3, 6).astype(np.float32)
    return A, y0


@pytest.mark.parametrize("method,substeps", SOLVERS)
def test_linear_system_matches_jax(method, substeps):
    A, y0 = _linear_system()
    hi = jax.lax.Precision.HIGHEST
    ref = jodeint(lambda t, y: jnp.matmul(y, jnp.asarray(A).T, precision=hi), jnp.asarray(y0),
                  jnp.asarray(T_SPAN), method=method, substeps=substeps)
    At = torch.from_numpy(A).T.contiguous()
    got = odeint(lambda t, y: y @ At, torch.from_numpy(y0), torch.from_numpy(T_SPAN),
                 method=method, substeps=substeps)
    assert got.shape == (len(T_SPAN), *y0.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("method,substeps", [("euler", 3), ("rk4", 1), ("dopri5", 1)])
def test_gde_field_matches_jax(method, substeps):
    rng = np.random.RandomState(1)
    W, N, D = 4, 5, 11
    obs = rng.rand(W, N, D).astype(np.float32)
    obs[..., :5] = rng.randint(0, 4, (W, N, 5)) * 0.5
    count = np.int32(3)
    obs[count:] = 0.0
    jmodel = JGraphODE(node_dim=D, num_agvs=2, hidden_dim=8)
    jg = jt.build_temporal_graph(jt.TemporalWindow(jnp.asarray(obs), jnp.asarray(count)), 2)
    params = jmodel.init(jax.random.PRNGKey(0), jg, jnp.asarray(T_SPAN))
    with jax.default_matmul_precision("highest"):
        ref = jodeint(lambda t, y: jmodel.func.apply(params["func"], t, y, jg.adj, jg.node_mask),
                      jg.x, jnp.asarray(T_SPAN), method=method, substeps=substeps)
    model = GraphODE(node_dim=D, num_agvs=2, hidden_dim=8)
    model.load_state_dict(
        convert.gde_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"))
    adj, mask, x = (torch.from_numpy(np.array(a)) for a in (jg.adj, jg.node_mask, jg.x))
    with torch.no_grad():
        got = odeint(lambda t, y: model.func(t, y, adj, mask), x,
                     torch.from_numpy(T_SPAN), method=method, substeps=substeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_dopri5_solves_linear_fixture_within_reference_tolerance():
    """As tests/test_torch_parity.py holds the JAX solver: within 5 units of
    the reference tolerances (rtol 1e-3, atol 1e-4, train_gde.py:83-84) of
    the closed form exp(At) y0, and 10 of the recorded trajectory."""
    fx = np.load(FIXTURES)
    At = torch.from_numpy(fx["lin_A"].astype(np.float32)).T.contiguous()
    ys = odeint(lambda t, y: y @ At, torch.from_numpy(fx["lin_y0"].astype(np.float32)),
                torch.from_numpy(fx["lin_t"].astype(np.float32)), method="dopri5",
                rtol=1e-3, atol=1e-4).numpy()
    exact = fx["lin_exact"]
    scale = 1e-4 + 1e-3 * np.abs(exact)
    assert (np.abs(ys - exact) / scale).max() < 5.0
    assert (np.abs(ys - fx["lin_dopri5"]) / scale).max() < 10.0


def test_dopri5_initial_step_stays_finite_at_rest():
    """A state at rest (f = 0, y = 0) takes the guarded branches of the
    initial-step heuristic: no NaN reaches the solution."""
    ys = odeint(lambda t, y: torch.zeros_like(y), torch.zeros(4), torch.tensor([0.0, 1.0, 2.0]),
                method="dopri5")
    assert torch.isfinite(ys).all() and (ys == 0).all()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown method"):
        odeint(lambda t, y: y, torch.zeros(2), torch.tensor([0.0, 1.0]), method="heun")
