"""The port's run_marl against the JAX package's, driven by JAX's own
draws (resets, step draws, exploration, replay samples) rebuilt in
run_marl's split order and starting from JAX's initial agent state:
actions, rewards and every replay item identical at every step, the
learn losses within 1e-4, the stats line and the greedy evaluation the
same. Then the served policy (serving.make_policy_fn) against JAX's:
identical actions, greedy, coordinated and sampled."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu import serving as jserving
from swarm_ode_tpu.rl import replay as jreplay
from swarm_ode_tpu.rl.qmix import QMIXAgent as JQMIXAgent
from swarm_ode_tpu.train import run_rl as jrun
from swarm_ode_tpu_torch import convert, serving
from swarm_ode_tpu_torch.train import run_rl
from torch_port_helpers import (
    MEDIUM,
    TINY,
    JaxMarlDraws,
    both,
    jax_agent,
    jax_example_graph,
    jax_observations,
    port_agent_state,
)

# tests/test_rl_loop.py's configuration, with a greedy evaluation.
LOOP = dict(env_id=TINY, algo="qmix", net="gnn", num_envs=2, num_episodes=2, hidden_dim=8,
            buffer_size=3000, batch_size=8, learn_every=10, n_step=2, seed=0, eval_every=2,
            eval_episodes=2)


def test_run_marl_matches_jax_step_for_step(monkeypatch):
    items, losses = [], []
    add_batch, learn = jreplay.add_batch, JQMIXAgent.learn

    def recording_add_batch(buf, it):
        jax.debug.callback(lambda x: items.append(jax.tree.map(np.array, x)), it, ordered=True)
        return add_batch(buf, it)

    def recording_learn(self, state, batch):
        new, aux = learn(self, state, batch)
        jax.debug.callback(lambda l: losses.append(float(l)), aux["loss"], ordered=True)
        return new, aux

    monkeypatch.setattr(jreplay, "add_batch", recording_add_batch)
    monkeypatch.setattr(JQMIXAgent, "learn", recording_learn)
    jout = jrun.run_marl(jrun.RLRunConfig(**LOOP), verbose=False)
    jax.effects_barrier()

    cfg = run_rl.RLRunConfig(**LOOP, device="cpu")
    jp, _, pp, _ = both(cfg.env_id)
    key = jax.random.PRNGKey(cfg.seed)
    key, k0 = jax.random.split(key)
    key, ki = jax.random.split(key)
    jagent, _ = jax_agent(cfg, jp)
    pagent, _ = run_rl.make_agent(cfg, pp)
    start = port_agent_state(jagent.init(ki, jax_example_graph(jp, k0)), pagent)
    pout = run_rl.run_marl(cfg, verbose=False, draws=JaxMarlDraws(jp, key, cfg.coordinated),
                           agent_state=start)

    steps, B = 500, cfg.num_envs
    assert len(items) == steps
    storage = pout["buffer"].storage
    for t, it in enumerate(items):
        got = jax.tree.map(lambda s: s[t * B:(t + 1) * B].numpy(), storage)
        for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(it), jax.tree.leaves(got)):
            assert np.array_equal(g, want) and g.dtype == want.dtype, (t, path)
    assert pout["buffer"].size == steps * B

    (jh,), (ph,) = jout["history"], pout["history"]
    for k in ("episode", "deliveries", "clashes", "stucks", "pick_rate", "eval_deliveries",
              "eval_pick_rate"):
        assert ph[k] == jh[k], k
    np.testing.assert_allclose(ph["return"], jh["return"], rtol=1e-6)
    np.testing.assert_allclose(ph["eval_return"], jh["eval_return"], rtol=1e-5)
    ready = pout["losses"][0] != 0
    assert ready.sum() >= 45 and len(losses) == len(ready)
    np.testing.assert_allclose(pout["losses"][0][ready], np.array(losses)[ready], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=1e-4)
    js, ps = jout["agent_state"], pout["agent_state"]
    assert int(ps.step) == int(js.step) == int(ready.sum())
    assert float(ps.epsilon) == float(js.epsilon)


@pytest.mark.parametrize("net", ["gnn", "gnode_comm"])
def test_served_policy_matches_jax(net):
    jp, jl, pp, _ = both(MEDIUM)
    cfg = run_rl.RLRunConfig(env_id=MEDIUM, net=net, hidden_dim=16, device="cpu")
    _, jnet = jax_agent(cfg, jp)
    jparams = jnet.init(jax.random.PRNGKey(11), jax_example_graph(jp, jax.random.PRNGKey(12)))
    sd = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jparams), device="cpu")
    _, pnet = run_rl.make_agent(cfg, pp)
    obs = jax_observations(jp, jl, 3, 40, seed=4, every=20)  # (3, 3, A, D)
    seeds = np.arange(3, dtype=np.uint32)
    for coordinated in (False, True):
        jpol = jax.jit(jax.vmap(jserving.make_policy_fn(jp, jnet, jparams, coordinated)))
        ppol = serving.make_policy_fn(pp, pnet, sd, coordinated)
        for o in obs:
            want = np.asarray(jpol(o))
            assert np.array_equal(ppol(torch.from_numpy(o)).numpy(), want)
            assert np.array_equal(ppol(torch.from_numpy(o[0])).numpy(), want[0])
    jpol = jax.jit(jax.vmap(jserving.make_policy_fn(jp, jnet, jparams, temperature=0.5)))
    ppol = serving.make_policy_fn(pp, pnet, sd, temperature=0.5)
    gum = jax.vmap(lambda s: jax.random.gumbel(jax.random.PRNGKey(s),
                                               (jp.num_agents, jp.num_actions)))(seeds)
    for o in obs:
        want = np.asarray(jpol(o, seeds))
        assert np.array_equal(ppol(torch.from_numpy(o), torch.from_numpy(np.array(gum))).numpy(),
                              want)
    assert ppol(torch.from_numpy(obs[0]), generator=torch.Generator().manual_seed(0)).shape == (
        3, jp.num_agents)


def test_unported_options_raise():
    with pytest.raises(ValueError, match="net='gru' currently supports algo='iql'"):
        run_rl.run_marl(run_rl.RLRunConfig(**{**LOOP, "net": "gru"}, device="cpu"),
                        verbose=False)
    with pytest.raises(ValueError, match="init_q_from supports"):
        run_rl.run_marl(run_rl.RLRunConfig(**{**LOOP, "algo": "coma",
                                              "init_q_from": "somewhere"}, device="cpu"),
                        verbose=False)
    with pytest.raises(ValueError, match="learn_every"):
        run_rl.run_marl(run_rl.RLRunConfig(**{**LOOP, "learn_every": 7}, device="cpu"),
                        verbose=False)


def test_cli_checkpoint_and_resume_restore_the_agent_bit_for_bit(tmp_path, capsys):
    """The CLI trains one stride on the CPU and checkpoints it; an eval-only
    run resuming from it restores the agent state bit for bit."""
    ckpt = tmp_path / "ckpt"
    argv = ["--env_id", TINY, "--algo", "iql", "--net", "gnn", "--num_envs", "2",
            "--num_episodes", "2", "--hidden_dim", "8", "--batch_size", "8",
            "--learn_every", "50", "--n_step", "2", "--checkpoint_dir", str(ckpt),
            "--checkpoint_every", "2", "--device", "cpu", "--out_dir", str(tmp_path / "runs")]
    run_rl.main(argv)
    assert "[iql+gnn] Episode 0:" in capsys.readouterr().out
    saved = torch.load(ckpt / "0.pt", weights_only=True)["agent"]
    cfg = run_rl.RLRunConfig(env_id=TINY, algo="iql", net="gnn", num_envs=2, num_episodes=0,
                             hidden_dim=8, eval_episodes=2, resume_from=str(ckpt), device="cpu")
    out = run_rl.run_marl(cfg, verbose=False)
    st = out["agent_state"]
    assert int(st.step) == 10 and out["history"][0]["episode"] == 2
    for name, v in st.params.items():
        assert torch.equal(v, saved["params"][name]), name
    for got, want in zip(st.opt_state.mu + st.opt_state.nu, saved["opt_state"][1] +
                         saved["opt_state"][2]):
        assert torch.equal(got, want)
    assert torch.equal(st.epsilon, saved["epsilon"])
    with pytest.raises(FileNotFoundError):
        run_rl.run_marl(dataclasses.replace(cfg, resume_from=str(tmp_path / "none")),
                        verbose=False)
