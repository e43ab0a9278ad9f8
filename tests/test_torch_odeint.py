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


def _nonlinear_problem():
    """dy/dt = tanh(y A^T) + b on a (3, 6) state, and a loss over every
    requested time: the step sizes dopri5 picks depend on A and b."""
    rng = np.random.RandomState(2)
    A = (-0.8 * np.eye(6) + 0.6 * rng.randn(6, 6)).astype(np.float32)
    b = (0.3 * rng.randn(6)).astype(np.float32)
    y0 = rng.randn(3, 6).astype(np.float32)
    w = rng.rand(len(T_SPAN), 3, 6).astype(np.float32)
    return A, b, y0, w


def _jax_grads(method, substeps, adjoint=False):
    from swarm_ode_tpu.ops.odeint import odeint_adjoint as jodeint_adjoint

    A, b, y0, w = _nonlinear_problem()
    hi = jax.lax.Precision.HIGHEST

    def f(t, y, p):
        return jnp.tanh(jnp.matmul(y, p[0].T, precision=hi)) + p[1]

    def loss(y0, p):
        if adjoint:
            ys = jodeint_adjoint(f, y0, jnp.asarray(T_SPAN), p, method=method, substeps=substeps)
        else:
            ys = jodeint(lambda t, y: f(t, y, p), y0, jnp.asarray(T_SPAN), method=method,
                         substeps=substeps)
        return jnp.sum(ys * w)

    gy, (gA, gb) = jax.grad(loss, argnums=(0, 1))(jnp.asarray(y0), (jnp.asarray(A), jnp.asarray(b)))
    return [np.asarray(x) for x in (gy, gA, gb)]


def _port_grads(method, substeps, checkpoint=False, adjoint=False):
    from swarm_ode_tpu_torch.ops.odeint import odeint_adjoint

    A, b, y0, w = (torch.from_numpy(x).requires_grad_() for x in _nonlinear_problem())

    def f(t, y, p):
        return torch.tanh(y @ p[0].T) + p[1]

    t = torch.from_numpy(T_SPAN)
    if adjoint:
        ys = odeint_adjoint(f, y0, t, (A, b), method=method, substeps=substeps)
    else:
        ys = odeint(lambda ti, y: f(ti, y, (A, b)), y0, t, method=method, substeps=substeps,
                    checkpoint=checkpoint)
    return [g.numpy() for g in torch.autograd.grad((ys * w).sum(), (y0, A, b))]


@pytest.mark.parametrize("method,substeps", SOLVERS)
def test_gradients_match_jax(method, substeps):
    """Gradients of a loss over every requested time with respect to y0 and
    the field's parameters, against jax.grad of the JAX solver. For dopri5
    this pins the detached step-size control: the initial step and the
    error norm carry no gradient in either package. 1e-5 of the largest
    gradient (float32 in the same order up to the matrix products' sums)."""
    ref = _jax_grads(method, substeps)
    for got, want in zip(_port_grads(method, substeps), ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("method,substeps", [("euler", 3), ("rk4", 2), ("dopri5", 1)])
def test_checkpoint_gives_the_same_gradients(method, substeps):
    """checkpoint=True recomputes each step (each dopri5 interval) in the
    backward pass: the same values and gradients, bit for bit on the CPU."""
    for a, b in zip(_port_grads(method, substeps, checkpoint=True), _port_grads(method, substeps)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,substeps", [("rk4", 4), ("dopri5", 1)])
def test_adjoint_matches_jax_adjoint(method, substeps):
    """odeint_adjoint's gradients (the augmented system integrated back
    segment by segment, the loss's cotangent added at every requested time)
    against the JAX package's odeint_adjoint: 1e-5 of the largest."""
    ref = _jax_grads(method, substeps, adjoint=True)
    for got, want in zip(_port_grads(method, substeps, adjoint=True), ref):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_adjoint_matches_direct_on_the_jax_case():
    """tests/test_odeint.py's adjoint case: dy/dt = -theta y + bias, rk4
    with 32 substeps, the loss at the last time. The port's adjoint
    gradients equal JAX's adjoint and the port's own direct gradients
    within the JAX test's tolerance (rtol 1e-4, atol 1e-6)."""
    from swarm_ode_tpu.ops.odeint import odeint_adjoint as jodeint_adjoint
    from swarm_ode_tpu_torch.ops.odeint import odeint_adjoint

    t = np.array([0.0, 0.5, 1.0], np.float32)

    def jf(ti, y, p):
        return -p["theta"] * y + p["bias"]

    def jloss(y0, p):
        return jnp.sum(jodeint_adjoint(jf, y0, jnp.asarray(t), p, method="rk4", substeps=32)[-1] ** 2)

    jy, jp = jax.grad(jloss, argnums=(0, 1))(
        jnp.array([1.0, 2.0]), {"theta": jnp.array(0.8), "bias": jnp.array(0.1)})
    ref = [np.asarray(jy), np.asarray(jp["theta"]), np.asarray(jp["bias"])]

    def port(adjoint):
        y0 = torch.tensor([1.0, 2.0], requires_grad=True)
        theta = torch.tensor(0.8, requires_grad=True)
        bias = torch.tensor(0.1, requires_grad=True)

        def f(ti, y, p):
            return -p[0] * y + p[1]

        if adjoint:
            ys = odeint_adjoint(f, y0, torch.from_numpy(t), (theta, bias), method="rk4",
                                substeps=32)
        else:
            ys = odeint(lambda ti, y: f(ti, y, (theta, bias)), y0, torch.from_numpy(t),
                        method="rk4", substeps=32)
        return [g.numpy() for g in torch.autograd.grad((ys[-1] ** 2).sum(), (y0, theta, bias))]

    for got, direct, want in zip(port(True), port(False), ref):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-6)
