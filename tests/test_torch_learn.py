"""One IQL and one QMIX learn step of the port against the JAX package's at
HIGHEST matmul precision, from the same agent state (JAX's initialisation
carried over by convert) and batch: IQL plain and coordinated, QMIX plain
and with each of value_transform, td_clip, huber_delta, target_tau and
coordinated, and two steps of a hard target sync every second step. The
loss within 1e-5, every gradient element within 1e-5 of the gradient's
largest, the parameters and target parameters after Adam within 1e-6, step,
epsilon and Adam's count identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.graphs import hetero as jh
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.train import run_rl
from torch_port_helpers import (
    TINY,
    both,
    jax_agent,
    jax_example_graph,
    jax_observations,
    port_agent_state,
)

HIGHEST = jax.default_matmul_precision("highest")


def _cfg(**kw):
    base = dict(env_id=TINY, algo="qmix", net="gnn", num_envs=2, hidden_dim=8, batch_size=8,
                n_step=2, value_transform=False, device="cpu")
    base.update(kw)
    return run_rl.RLRunConfig(**base)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max error {err:.3g} > {tol} x {scale:.3g}"


def _batch(jp, jl, cfg, B=8, seed=0):
    """A sampled-batch stand-in from a JAX rollout: features of
    consecutive observations, random actions, rewards, dones and chain
    lengths, as numpy."""
    obs = jax_observations(jp, jl, 4, 12, seed=seed, every=1)  # (13, 4, A, D)
    rng = np.random.RandomState(seed)
    k = rng.randint(0, obs.shape[0] - 1, B)
    e = rng.randint(0, obs.shape[1], B)
    split = jax.vmap(lambda o: jh.split_observation(jp, o))
    cur = [np.asarray(x) for x in split(obs[k, e])]
    nxt = [np.asarray(x) for x in split(obs[k + 1, e])]
    feats = lambda f: {"agv": f[0], "picker": f[1], "loc": f[2]}
    scale = np.float32(1.0 / max(jp.grid_h, jp.grid_w))
    gs = lambda f: np.concatenate([x.reshape(B, -1) for x in f], 1) * scale
    gamma = 0.99 if cfg.algo == "iql" else 0.999
    m = rng.randint(1, cfg.n_step + 1, B)
    batch = {"obs_feats": feats(cur), "next_feats": feats(nxt),
             "actions": rng.randint(0, jp.num_actions, (B, jp.num_agents)).astype(np.int32),
             "gamma_eff": (np.float32(gamma) ** m.astype(np.float32)).astype(np.float32)}
    done = rng.rand(B) < 0.25
    if cfg.algo == "iql":
        batch.update(rewards=rng.randn(B, jp.num_agents).astype(np.float32), dones=done)
    else:
        batch.update(reward=(3 * rng.randn(B)).astype(np.float32), done=done,
                     global_state=gs(cur), next_global_state=gs(nxt))
    return batch


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


LEARN_CASES = [
    dict(algo="iql", net="gnode"),
    dict(algo="iql", net="gnn", coordinated=True),
    dict(algo="qmix", net="gnode"),
    dict(algo="qmix", net="gnn", value_transform=True),
    dict(algo="qmix", net="gnn", td_clip=0.5),
    dict(algo="qmix", net="gnn", huber_delta=0.1),
    dict(algo="qmix", net="gnn", target_tau=0.05),
    dict(algo="qmix", net="gnode_comm", coordinated=True, value_transform=True),
    dict(algo="qmix", net="gnn", update_target_freq=2),
]


@pytest.mark.parametrize("case", LEARN_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_learn_step_matches_jax(case):
    case = dict(case)
    freq = case.pop("update_target_freq", None)
    cfg = _cfg(**case)
    jp, jl, pp, _ = both(cfg.env_id)
    jagent, _ = jax_agent(cfg, jp)
    pagent, _ = run_rl.make_agent(cfg, pp)
    if freq:
        jagent.cfg.update_target_freq = pagent.cfg.update_target_freq = freq
    jstate = jagent.init(jax.random.PRNGKey(5), jax_example_graph(jp, jax.random.PRNGKey(6)))
    pstate = port_agent_state(jstate, pagent)
    learn = jax.jit(jagent.learn)
    for step in range(2 if freq else 1):
        batch = _batch(jp, jl, cfg, seed=step)
        with HIGHEST:
            jstate, aux = learn(jstate, jax.tree.map(jnp.asarray, batch))
        pstate, paux, grads = pagent.learn_with_grads(pstate, _torch_tree(batch))
        _close(paux["loss"], aux["loss"], 1e-5, f"loss {step}")
        assert float(aux["loss"]) != 0.0
        want = convert.agent_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                              list(pstate.params), device="cpu")
        assert torch.equal(pstate.step, want.step) and torch.equal(pstate.epsilon, want.epsilon)
        assert torch.equal(pstate.opt_state.count, want.opt_state.count)
        # Adam's first moment holds the clipped gradient (mu = 0.1 g at step
        # 1, 0.9 mu + 0.1 g after): every element within 1e-5 of the
        # largest element of the whole gradient.
        scale = max(float(m.abs().max()) for m in want.opt_state.mu)
        for (name, _), m_got, m_want in zip(pstate.params.items(), pstate.opt_state.mu,
                                            want.opt_state.mu):
            err = float((m_got - m_want).abs().max())
            assert err <= 1e-5 * scale, f"gradient {name} {step}: {err:.3g} vs {scale:.3g}"
        for name, p in pstate.params.items():
            np.testing.assert_allclose(p.numpy(), want.params[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"params {name} {step}")
            np.testing.assert_allclose(pstate.target_params[name].numpy(),
                                       want.target_params[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"target {name} {step}")
        assert set(grads) == set(pstate.params)
    back = convert.agent_state_to_numpy(pstate, cfg.net, cfg.algo)
    assert jax.tree.structure(back["params"]) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate.params))
