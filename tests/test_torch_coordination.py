"""The port's claim auction (rl/coordination.py) and epsilon-greedy
selection (rl/dqn.epsilon_greedy) against the JAX package's, given the
same Q-values and JAX's own draws: actions bit for bit, the density of
sequential_log_prob bit for bit where it is an integer question (which
actions have zero probability) and within 2e-6 as floats."""
import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.rl import coordination as jc
from swarm_ode_tpu.rl.dqn import DQNConfig, DQNState, IQLAgent
from swarm_ode_tpu_torch.rl import coordination as pc
from swarm_ode_tpu_torch.rl.dqn import epsilon_greedy
from torch_port_helpers import TINY, MEDIUM, both

NA, RACK = 5, 4  # AGVs, first rack action


def _inputs(seed, B=6, A=9, n=14, contention=True):
    """Q-values with contention (agents sharing a preferred rack), masks
    with invalid entries (column 0 always valid), busy agents."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, A, n).astype(np.float32)
    if contention:
        q += 3.0 * rng.randn(B, 1, n).astype(np.float32)
    masks = (rng.rand(B, A, n) < 0.6).astype(np.float32)
    masks[..., 0] = 1.0
    active = rng.rand(B, A) < 0.75
    return q, masks, active


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_matches_jax(seed):
    q, masks, active = _inputs(seed)
    B, A, n = q.shape
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jargmax = jax.vmap(lambda q, m, a: jc.coordinated_argmax(q, m, NA, RACK, a))
    got = pc.coordinated_argmax(_t(q), _t(masks), NA, RACK, _t(active))
    assert np.array_equal(got.numpy(), np.asarray(jargmax(q, masks, active)))
    # Order overridden; all agents active by default.
    scores = np.random.RandomState(seed + 10).randn(B, A).astype(np.float32)
    want = jax.vmap(lambda q, m, s: jc.coordinated_argmax(q, m, NA, RACK, order_scores=s))(
        q, masks, scores)
    got = pc.coordinated_argmax(_t(q), _t(masks), NA, RACK, order_scores=_t(scores))
    assert np.array_equal(got.numpy(), np.asarray(want))
    order = jax.vmap(jc._selection_order)(scores, active)
    assert np.array_equal(pc._selection_order(_t(scores), _t(active)).numpy(), np.asarray(order))

    for eps in (0.0, 0.3, 1.0):
        want = jax.vmap(lambda q, m, k, a: jc.coordinated_epsilon_greedy(
            q, m, NA, RACK, eps, k, active=a))(q, masks, keys, active)
        k12 = jax.vmap(jax.random.split)(keys)
        u1 = jax.vmap(lambda k: jax.random.uniform(k, (A,)))(k12[:, 0])
        u2 = jax.vmap(lambda k: jax.random.uniform(k, (A, n)))(k12[:, 1])
        got = pc.coordinated_epsilon_greedy(_t(q), _t(masks), NA, RACK, eps, _t(u1), _t(u2),
                                            active=_t(active))
        assert np.array_equal(got.numpy(), np.asarray(want)), eps

    want = jax.vmap(lambda q, m, k, a: jc.coordinated_sample(q, m, NA, RACK, k, a))(
        q, masks, keys, active)
    gum = jax.vmap(lambda k: jax.random.gumbel(k, (A, n)))(keys)
    sampled = pc.coordinated_sample(_t(q), _t(masks), NA, RACK, _t(gum), _t(active))
    assert np.array_equal(sampled.numpy(), np.asarray(want))

    # The density of the sampled actions, and of actions taken at random
    # (some double-booked: zero probability, log-probability ~ -1e9).
    rand_acts = np.random.RandomState(seed).randint(0, n, (B, A)).astype(np.int32)
    for acts in (np.asarray(want), rand_acts):
        jlp, jent = jax.vmap(lambda q, m, a, act: jc.sequential_log_prob(q, m, a, NA, RACK, act))(
            q, masks, acts, active)
        lp, ent = pc.sequential_log_prob(_t(q), _t(masks), _t(acts), NA, RACK, _t(active))
        assert np.array_equal(lp.numpy() < -1e8, np.asarray(jlp) < -1e8)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=2e-6, atol=2e-6)


def test_auction_resolves_real_contention():
    """The inputs above do contend: the auction's actions differ from the
    independent argmax somewhere (else the test would be vacuous)."""
    q, masks, active = _inputs(0)
    got = pc.coordinated_argmax(_t(q), _t(masks), NA, RACK, _t(active)).numpy()
    indep = np.where(masks > 0, q, -np.inf).argmax(-1)
    assert (got != indep).any()


class _FixedQ:
    """A 'network' whose Q-values are its parameters, for JAX's act."""

    def apply(self, params, graph):
        return {"agv_q_values": params["agv"], "picker_q_values": params["pick"]}


@pytest.mark.parametrize("env_id", [TINY, MEDIUM])
@pytest.mark.parametrize("coordinated", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_epsilon_greedy_matches_jax_act(env_id, coordinated, training):
    jp, _, pp, _ = both(env_id)
    B, A, n = 5, jp.num_agents, jp.num_actions
    rng = np.random.RandomState(int(coordinated) + 2 * int(training))
    q = (rng.randn(B, A, n) + 2.0 * rng.randn(B, 1, n)).astype(np.float32)
    masks = (rng.rand(B, A, n) < 0.3).astype(np.float32)
    masks[..., 0] = 1.0
    active = rng.rand(B, A) < 0.7
    eps = np.float32(0.4)
    agent = IQLAgent(_FixedQ(), jp, DQNConfig(coordinated=coordinated))
    keys = jax.random.split(jax.random.PRNGKey(7), B)

    def one(q, m, k, a):
        state = DQNState(params={"agv": q[:jp.num_agvs], "pick": q[jp.num_agvs:]},
                         target_params=None, opt_state=None, epsilon=eps, step=0)
        return agent.act(state, None, m, k, training=training, active=a)

    want = np.asarray(jax.vmap(one)(q, masks, keys, active))
    k12 = jax.vmap(jax.random.split)(keys)
    if coordinated:
        explore_u = jax.vmap(lambda k: jax.random.uniform(k, (A,)))(k12[:, 0])
        row = jax.vmap(lambda k: jax.random.uniform(k, (A, n)))(k12[:, 1])
    else:
        row = jax.vmap(lambda k: jax.random.gumbel(k, (A, n)))(k12[:, 0])
        explore_u = jax.vmap(lambda k: jax.random.uniform(k, (A,)))(k12[:, 1])
    from swarm_ode_tpu_torch.rl.dqn import ActNoise

    noise = ActNoise(_t(explore_u), _t(row))
    got = epsilon_greedy(_t(q), _t(masks), torch.tensor(eps), noise, pp, coordinated,
                         _t(active), training)
    assert np.array_equal(got.numpy(), want)
    if training:
        greedy = epsilon_greedy(_t(q), _t(masks), torch.tensor(eps), None, pp, coordinated,
                                _t(active))
        assert (got.numpy() != greedy.numpy()).any()  # some agents explored
