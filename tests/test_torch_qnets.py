"""The port's Q-networks (gnn, gnode, gnode_comm) and mixers against the
JAX package's at HIGHEST matmul precision, from the same parameters (JAX's
flax initialisation carried over by convert, and back): Q-values within
1e-5 of the largest |Q|."""
import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.graphs import hetero as jh
from swarm_ode_tpu.models.qmix import HeteroQMIXMixer as JMixer, QMixer as JQMixer
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.graphs import hetero as ph
from swarm_ode_tpu_torch.models.qmix import HeteroQMIXMixer, QMixer
from swarm_ode_tpu_torch.rl.dqn import q_values
from swarm_ode_tpu_torch.train import run_rl
from torch_port_helpers import (
    MEDIUM,
    TINY,
    both,
    jax_agent,
    jax_example_graph,
    jax_observations,
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


@pytest.mark.parametrize("env_id,net,hidden", [
    (TINY, "gnn", 8), (TINY, "gnode", 8), (TINY, "gnode_comm", 8), (MEDIUM, "gnode", 32),
    (MEDIUM, "gnn", 16), (MEDIUM, "gnode_comm", 16),
])
def test_q_networks_match_jax(env_id, net, hidden):
    jp, jl, pp, _ = both(env_id)
    cfg = _cfg(env_id=env_id, net=net, hidden_dim=hidden, algo="iql")
    jagent, jnet = jax_agent(cfg, jp)
    jparams = jnet.init(jax.random.PRNGKey(3), jax_example_graph(jp, jax.random.PRNGKey(4)))
    pagent, pnet = run_rl.make_agent(cfg, pp)
    sd = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jparams), device="cpu")
    pnet.load_state_dict(sd)
    back = convert.qnet_params_to_numpy(sd, net)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert np.array_equal(a, np.asarray(b))
    obs = jax_observations(jp, jl, 3, 30, seed=2, every=10)
    with HIGHEST:
        q_j = jax.jit(jax.vmap(lambda o: jagent.q_values(
            jparams, jh.hetero_graph_from_obs(jp, o))))
        for o in obs:
            got = q_values(pnet, dict(pnet.named_parameters()),
                           ph.hetero_graph_from_obs(pp, torch.from_numpy(o)))
            _close(got.detach(), q_j(o), 1e-5, f"{net} Q")


def test_mixers_match_jax():
    rng = np.random.RandomState(0)
    qs = rng.randn(6, 28).astype(np.float32)
    s = rng.randn(6, 489).astype(np.float32)
    for jm, pm in ((JMixer(num_agents=28), HeteroQMIXMixer(28, 489)),
                   (JQMixer(num_agents=28, state_dim=489), QMixer(28, 489))):
        jparams = jm.init(jax.random.PRNGKey(1), qs[:1], s[:1])
        sd = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jparams), device="cpu")
        pm.load_state_dict(sd)
        back = convert.mixer_params_to_numpy(sd)
        assert jax.tree.structure(back) == jax.tree.structure(jparams)
        with HIGHEST:
            want = jm.apply(jparams, qs, s)
        _close(pm(torch.from_numpy(qs), torch.from_numpy(s)).detach(), want, 1e-5,
               type(pm).__name__)
