"""The port's recurrent models (models/gru.py) and the graph-GRU IQL path
against the JAX package's, on the CPU, JAX at HIGHEST matmul precision and
the weights carried by convert: both cells and the five models within 1e-5
of the largest output; an IQL learn step from stored hidden states; the
served GRU policy's actions identical; run_marl(net="gru") step for step on
JAX's own draws; the refusals, the CLI, checkpoints and resume."""
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu import serving as jserving
from swarm_ode_tpu.graphs import hetero as jh
from swarm_ode_tpu.models import gru as jgru
from swarm_ode_tpu.rl import replay as jreplay
from swarm_ode_tpu.rl.dqn import IQLAgent as JIQLAgent
from swarm_ode_tpu.train import run_rl as jrun
from swarm_ode_tpu_torch import convert, serving
from swarm_ode_tpu_torch.graphs import hetero as ph
from swarm_ode_tpu_torch.models import gru as pgru
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

HIGHEST = jax.default_matmul_precision("highest")


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max error {err:.3g} > {tol} x {scale:.3g}"


def _sd(tree):
    return convert.flax_params_to_state_dict(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_cells_match_flax(kind):
    """One step of each cell from a random carry, and three steps chained."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)  # (T, S, D)
    if kind == "gru":
        jcell, pcell = fnn.GRUCell(7), pgru.GRUCell(5, 7)
        carry = rng.normal(size=(6, 7)).astype(np.float32)
        pcarry = torch.from_numpy(carry)
    else:
        jcell, pcell = fnn.OptimizedLSTMCell(7), pgru.LSTMCell(5, 7)
        carry = tuple(rng.normal(size=(6, 7)).astype(np.float32) for _ in range(2))
        pcarry = tuple(torch.from_numpy(c) for c in carry)
    params = jcell.init(jax.random.PRNGKey(1), carry, x[0])
    sd = _sd(params)
    assert set(sd) == set(pcell.state_dict())
    pcell.load_state_dict(sd)
    with HIGHEST:
        for t in range(3):
            carry, _ = jcell.apply(params, carry, x[t])
            pcarry = pcell(pcarry, torch.from_numpy(x[t]))
            for got, want in zip(jax.tree.leaves(pcarry), jax.tree.leaves(carry)):
                _close(got.detach(), want, 1e-5, f"{kind} step {t}")


SEQ_MODELS = {
    "gru": (lambda h: jgru.GRUTrajectoryPredictor(9, 4, hidden_dim=h),
            lambda h: pgru.GRUTrajectoryPredictor(9, 4, h), 9),
    "lstm": (lambda h: jgru.LSTMTrajectoryPredictor(9, 4, hidden_dim=h),
             lambda h: pgru.LSTMTrajectoryPredictor(9, 4, h), 9),
    "pos_gru": (lambda h: jgru.PositionOnlyGRU(4, hidden_dim=h),
                lambda h: pgru.PositionOnlyGRU(4, h), 2),
    "pos_lstm": (lambda h: jgru.PositionOnlyLSTM(4, hidden_dim=h),
                 lambda h: pgru.PositionOnlyLSTM(4, h), 2),
}


@pytest.mark.parametrize("name", sorted(SEQ_MODELS))
def test_sequence_models_match_flax(name):
    """(B, T, N, D) -> (B, N, 2) within 1e-5, and convert's tree round trip."""
    jf, pf, D = SEQ_MODELS[name]
    x = np.random.RandomState(2).normal(size=(3, 5, 4, D)).astype(np.float32) * 3
    jm, pm = jf(16), pf(16)
    params = jm.init(jax.random.PRNGKey(3), x)
    sd = _sd(params)
    pm.load_state_dict(sd)
    with HIGHEST:
        want = jm.apply(params, x)
    got = pm(torch.from_numpy(x)).detach()
    assert got.shape == (3, 4, 2)
    _close(got, want, 1e-5, name)
    back = convert.qnet_params_to_numpy(sd, "gru")
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, params))


def test_init_draws_as_flax_does():
    """init_: input kernels lecun-normal (truncated at two of their draw's
    standard deviations, sample std within 10% of sqrt(1/fan_in)),
    recurrent kernels orthogonal (W W^T = I), biases zero; the names and
    shapes of flax's tree; the same seed gives the same draws."""
    x = np.zeros((2, 5, 28, 64), np.float32)
    for name in SEQ_MODELS:
        jf, pf, D = SEQ_MODELS[name]
        jm, pm = jf(64), pf(64)
        ref = _sd(jm.init(jax.random.PRNGKey(0), x[..., :D]))
        pm.init_(torch.Generator().manual_seed(0))
        sd = pm.state_dict()
        assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in ref.items()}
        for k, v in sd.items():
            if k.endswith("bias"):
                assert not v.any(), k
            elif "Cell_" in k and k.split(".")[-2].startswith("h"):
                eye = torch.eye(v.shape[0])
                assert torch.allclose(v @ v.T, eye, atol=1e-5), k
                assert torch.allclose(ref[k] @ ref[k].T, eye, atol=1e-5), k
            else:
                std = np.sqrt(1.0 / v.shape[1])
                assert float(v.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7, k
                if v.numel() >= 512:
                    assert abs(float(v.std()) / std - 1) < 0.1, k
        again = pf(64).init_(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(again.parameters(), pm.parameters()))


def _gru_cfg(**kw):
    base = dict(env_id=TINY, algo="iql", net="gru", num_envs=2, hidden_dim=8, batch_size=8,
                n_step=2, device="cpu")
    base.update(kw)
    return run_rl.RLRunConfig(**base)


@functools.lru_cache(maxsize=1)
def _medium_gru():
    """(JAX params, port params, JAX GRU network and its parameters, the
    port's network, (3, 3, A, D) medium observations) at hidden 16."""
    jp, jl, pp, _ = both(MEDIUM)
    cfg = _gru_cfg(env_id=MEDIUM, hidden_dim=16)
    _, jnet = jax_agent(cfg, jp)
    jparams = jnet.init(jax.random.PRNGKey(11), jax_example_graph(jp, jax.random.PRNGKey(12)))
    _, pnet = run_rl.make_agent(cfg, pp)
    obs = jax_observations(jp, jl, 3, 40, seed=4, every=20)
    return jp, pp, jnet, jparams, pnet, obs


def test_graph_gru_network_matches_flax():
    """HeteroGraphGRUNetwork on medium graphs (B = 3) from random hidden
    states: Q-values, new hidden states and embeddings within 1e-5; without
    hidden states it starts from zeros, as JAX's wrapper does."""
    jp, pp, jnet, jparams, pnet, obs = _medium_gru()
    pnet.load_state_dict(_sd(jparams))
    obs = obs[-1]  # (3, A, D)
    rng = np.random.RandomState(4)
    ha = rng.normal(size=(3, jp.num_agvs, 16)).astype(np.float32)
    hp = rng.normal(size=(3, jp.num_pickers, 16)).astype(np.float32)
    with HIGHEST:
        want = jax.jit(jax.vmap(lambda o, a, b: jnet.apply(
            jparams, jh.hetero_graph_from_obs(jp, o), a, b)))(obs, ha, hp)
        want0 = jax.jit(jax.vmap(lambda o: jnet.apply(
            jparams, jh.hetero_graph_from_obs(jp, o))))(obs)
    g = ph.hetero_graph_from_obs(pp, torch.from_numpy(obs))
    with torch.no_grad():
        got = pnet(g, torch.from_numpy(ha), torch.from_numpy(hp))
        got0 = pnet(g)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)
        _close(got0[k], want0[k], 1e-5, f"{k} from zeros")


def test_learn_step_from_stored_hidden_states_matches_jax():
    """One IQL learn step on a batch whose transitions carry hidden states
    (extras for the online pass, next_extras for the target's): the loss
    within 1e-5, Adam's first moment within 1e-5 of the gradient's largest
    element, the parameters within 1e-6."""
    cfg = _gru_cfg(hidden_dim=8)
    jp, jl, pp, _ = both(TINY)
    jagent, _ = jax_agent(cfg, jp)
    pagent, _ = run_rl.make_agent(cfg, pp)
    jstate = jagent.init(jax.random.PRNGKey(5), jax_example_graph(jp, jax.random.PRNGKey(6)))
    pstate = port_agent_state(jstate, pagent)
    obs = jax_observations(jp, jl, 4, 6, seed=0, every=1)  # (7, 4, A, D)
    rng = np.random.RandomState(0)
    B = 8
    k, e = rng.randint(0, obs.shape[0] - 1, B), rng.randint(0, 4, B)
    split = jax.vmap(lambda o: jh.split_observation(jp, o))
    feats = lambda f: dict(zip(("agv", "picker", "loc"), (np.asarray(x) for x in f)))
    hid = lambda: (rng.normal(size=(B, jp.num_agvs, 8)).astype(np.float32),
                   rng.normal(size=(B, jp.num_pickers, 8)).astype(np.float32))
    batch = {"obs_feats": feats(split(obs[k, e])), "next_feats": feats(split(obs[k + 1, e])),
             "actions": rng.randint(0, jp.num_actions, (B, jp.num_agents)).astype(np.int32),
             "rewards": rng.randn(B, jp.num_agents).astype(np.float32),
             "dones": rng.rand(B) < 0.25,
             "gamma_eff": np.full(B, 0.99 ** 2, np.float32),
             "extras": hid(), "next_extras": hid()}
    with HIGHEST:
        jstate, aux = jax.jit(jagent.learn)(jstate, jax.tree.map(jnp.asarray, batch))
    pstate, paux, _ = pagent.learn_with_grads(
        pstate, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), batch))
    _close(paux["loss"], aux["loss"], 1e-5, "loss")
    want = convert.agent_state_from_numpy(jax.tree.map(np.asarray, jstate), list(pstate.params),
                                          device="cpu")
    scale = max(float(m.abs().max()) for m in want.opt_state.mu)
    for n, a, b in zip(pstate.params, pstate.opt_state.mu, want.opt_state.mu):
        assert float((a - b).abs().max()) <= 1e-5 * scale, n
    for n, v in pstate.params.items():
        np.testing.assert_allclose(v.numpy(), want.params[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    back = convert.agent_state_to_numpy(pstate, "gru", "iql")
    assert jax.tree.structure(back["params"]) == jax.tree.structure(
        jax.tree.map(np.asarray, jstate.params))


def test_served_gru_policy_matches_jax():
    """make_policy_fn serves the GRU Q-network as JAX's serves its wrapper:
    from zero hidden states each call, greedy and through the claim
    auction, identical actions on medium observations."""
    jp, pp, jnet, jparams, pnet, obs = _medium_gru()
    for coordinated in (False, True):
        jpol = jax.jit(jax.vmap(jserving.make_policy_fn(jp, jnet, jparams, coordinated)))
        ppol = serving.make_policy_fn(pp, pnet, _sd(jparams), coordinated)
        for o in obs:
            want = np.asarray(jpol(o))
            assert np.array_equal(ppol(torch.from_numpy(o)).numpy(), want)
            assert np.array_equal(ppol(torch.from_numpy(o[0])).numpy(), want[0])


# JAX's run_rl.py with net="gru" (IQL), tiny, with a greedy evaluation.
LOOP = dict(env_id=TINY, algo="iql", net="gru", num_envs=2, num_episodes=2, hidden_dim=8,
            buffer_size=3000, batch_size=8, learn_every=10, n_step=2, seed=0, eval_every=2,
            eval_episodes=2)


def test_run_marl_gru_matches_jax_step_for_step(monkeypatch):
    """JAX's run_marl(net="gru") and the port's on JAX's draws from JAX's
    initial agent state: every replay item's integers and features
    identical, its hidden states (extras, next_extras: float network
    outputs carried over 500 steps) within 1e-5 of their largest, the learn
    losses within 1e-4, epsilon and step equal, the stats and the greedy
    evaluation the same."""
    items, losses = [], []
    add_batch, learn = jreplay.add_batch, JIQLAgent.learn

    def recording_add_batch(buf, it):
        jax.debug.callback(lambda x: items.append(jax.tree.map(np.array, x)), it, ordered=True)
        return add_batch(buf, it)

    def recording_learn(self, state, batch):
        new, aux = learn(self, state, batch)
        jax.debug.callback(lambda l: losses.append(float(l)), aux["loss"], ordered=True)
        return new, aux

    monkeypatch.setattr(jreplay, "add_batch", recording_add_batch)
    monkeypatch.setattr(JIQLAgent, "learn", recording_learn)
    with HIGHEST:
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
    assert set(storage) == set(items[0])
    for t, it in enumerate(items):
        got = jax.tree.map(lambda s: s[t * B:(t + 1) * B].numpy(), storage)
        for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(it), jax.tree.leaves(got)):
            assert g.dtype == want.dtype and g.shape == want.shape, (t, path)
            if "extras" in jax.tree_util.keystr(path):
                _close(g, want, 1e-5, f"step {t} {jax.tree_util.keystr(path)}")
            else:
                assert np.array_equal(g, want), (t, path)
    assert np.abs(items[-1]["extras"][0]).max() > 0.01  # the hidden states moved
    (jh_, ), (ph_, ) = jout["history"], pout["history"]
    for k in ("episode", "deliveries", "clashes", "stucks", "pick_rate", "eval_deliveries"):
        assert ph_[k] == jh_[k], k
    np.testing.assert_allclose(ph_["return"], jh_["return"], rtol=1e-6)
    np.testing.assert_allclose(ph_["eval_return"], jh_["eval_return"], rtol=1e-5)
    ready = pout["losses"][0] != 0
    assert ready.sum() >= 45 and len(losses) == len(ready)
    np.testing.assert_allclose(pout["losses"][0][ready], np.array(losses)[ready], rtol=1e-4,
                               atol=1e-6)
    js, ps = jout["agent_state"], pout["agent_state"]
    assert int(ps.step) == int(js.step) == int(ready.sum())
    assert float(ps.epsilon) == float(js.epsilon)


@pytest.mark.parametrize("algo", ["qmix", "coma"])
def test_gru_with_another_algo_raises_as_jax(algo):
    """JAX's refusal (swarm_ode_tpu/train/run_rl.py:232-234), word for word."""
    with pytest.raises(ValueError, match="^net='gru' currently supports algo='iql'$"):
        run_rl.run_marl(run_rl.RLRunConfig(**{**LOOP, "algo": algo}, device="cpu"),
                        verbose=False)


def test_cli_gru_checkpoint_and_resume_restore_the_agent_bit_for_bit(tmp_path, capsys):
    """`--net gru` trains one stride on the CPU and checkpoints it; the
    buffer holds one hidden state pair per item, allocated once; an
    eval-only run resuming from the checkpoint restores the agent bit for
    bit and evaluates from zero hidden states."""
    ckpt = tmp_path / "ckpt"
    argv = ["--env_id", TINY, "--algo", "iql", "--net", "gru", "--num_envs", "2",
            "--num_episodes", "2", "--hidden_dim", "8", "--batch_size", "8",
            "--learn_every", "50", "--n_step", "2", "--checkpoint_dir", str(ckpt),
            "--checkpoint_every", "2", "--device", "cpu", "--out_dir", str(tmp_path / "runs")]
    run_rl.main(argv)
    assert "[iql+gru] Episode 0:" in capsys.readouterr().out
    saved = torch.load(ckpt / "0.pt", weights_only=True)["agent"]
    cfg = _gru_cfg(num_episodes=0, eval_episodes=2, resume_from=str(ckpt))
    out = run_rl.run_marl(cfg, verbose=False)
    st = out["agent_state"]
    assert int(st.step) == 10 and out["history"][0]["episode"] == 2
    assert {k for k in st.params if k.startswith(("agv_gru.", "picker_gru."))}
    for name, v in st.params.items():
        assert torch.equal(v, saved["params"][name]), name
        assert torch.equal(st.target_params[name], saved["target_params"][name]), name
    for got, want in zip(st.opt_state.mu + st.opt_state.nu, saved["opt_state"][1] +
                         saved["opt_state"][2]):
        assert torch.equal(got, want)
    assert torch.equal(st.epsilon, saved["epsilon"])

    run = run_rl.MarlRun(dataclasses.replace(cfg, resume_from=None, buffer_size=64))
    ex = run.buf.storage["extras"]
    assert [tuple(h.shape) for h in ex] == [(64, 3, 8), (64, 2, 8)]
    ptrs = [h.data_ptr() for h in ex]
    es = run.draws.reset(2)
    from swarm_ode_tpu_torch.env.observations import observe
    obs = observe(run.params, es)
    for t in range(3):
        prev = run.hidden
        es, obs, _ = run.env_step(es, obs, t, 0)
        if t == 0:
            assert prev is None
    assert [h.data_ptr() for h in run.buf.storage["extras"]] == ptrs
    nxt = run.buf.storage["next_extras"]
    for a, b in zip(run.buf.storage["extras"], nxt):
        assert not a[0:2].any() and torch.equal(a[2:6], b[0:4])
