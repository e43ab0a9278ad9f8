"""COMA in the port against the JAX package's at HIGHEST matmul precision:
the actor, the critic and the counterfactual advantage on the same
parameters and inputs; one COMAAgent.update (coordinated or not, with the
counterfactual baseline or the simplified advantage) from the same state
and batch: both losses, every gradient, and the parameters after Adam from
the same gradients; the gradient of sequential_log_prob against jax.grad;
then run_marl(algo="coma") step for step on JAX's own draws (tiny, 2 envs,
two strides of short episodes), and a checkpoint resumed bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swarm_ode_tpu.config import EnvConfig as JEnvConfig
from swarm_ode_tpu.graphs import hetero as jh
from swarm_ode_tpu.models import coma as jcoma
from swarm_ode_tpu.rl import coma as jrl_coma
from swarm_ode_tpu.rl import coordination as jcoord
from swarm_ode_tpu.rl import replay as jreplay
from swarm_ode_tpu.train import run_rl as jrun
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.config import EnvConfig as PEnvConfig
from swarm_ode_tpu_torch.models import coma as pcoma
from swarm_ode_tpu_torch.rl import coordination as pcoord
from swarm_ode_tpu_torch.rl.dqn import adam_step
from swarm_ode_tpu_torch.train import run_rl
from torch_port_helpers import (
    TINY,
    JaxMarlDraws,
    both,
    jax_agent,
    jax_example_graph,
    jax_observations,
    port_agent_state,
)

HIGHEST = jax.default_matmul_precision("highest")
TOL = 1e-6


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max error {err:.3g} > {tol} x {scale:.3g}"


def _t(a):
    return torch.from_numpy(np.array(a))


def test_actor_critic_and_counterfactual_advantage_match_jax():
    rng = np.random.RandomState(0)
    B, S, N, n = 6, 11, 5, 7
    obs = rng.randn(B, N, 9).astype(np.float32)
    gs = rng.randn(B, S).astype(np.float32)
    acts = rng.randint(0, n, (B, N)).astype(np.int32)
    mask = (rng.rand(B, N, n) < 0.6).astype(np.float32)
    mask[..., 0] = 1.0
    jactor, jcritic = jcoma.COMAActor(n, 16), jcoma.COMACritic(N, n, 12)
    ap = jactor.init(jax.random.PRNGKey(1), obs)
    cp = jcritic.init(jax.random.PRNGKey(2), gs, acts)
    pactor, pcritic = pcoma.COMAActor(9, n, 16), pcoma.COMACritic(S, N, n, 12)
    pactor.load_state_dict(convert.flax_params_to_state_dict(jax.tree.map(np.asarray, ap), "cpu"))
    csd = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, cp), "cpu")
    pcritic.load_state_dict(csd)
    with HIGHEST:
        logits = jactor.apply(ap, obs)
        probs = jcoma.masked_action_probs(logits, mask)
        q = jcritic.apply(cp, gs, acts)
        cf = jax.jit(lambda i: jcoma.counterfactual_advantage(
            jcritic.apply, cp, gs, jnp.asarray(acts), probs[:, i], i, n))
        adv = [cf(i) for i in range(N)]
    with torch.no_grad():
        plogits = pactor(_t(obs))
        pprobs = pcoma.masked_action_probs(plogits, _t(mask))
        pq = pcritic(_t(gs), _t(acts))
        padv = [pcoma.counterfactual_advantage(pcritic, csd, _t(gs), _t(acts), pprobs[:, i], i)
                for i in range(N)]
    _close(plogits, logits, TOL, "actor logits")
    _close(pprobs, probs, TOL, "masked probabilities")
    assert float(pprobs[_t(mask) == 0].max()) == 0.0
    _close(pq, q, TOL, "critic Q")
    # A_i is a difference of Q-values: its rounding is that of the Q scale.
    scale = float(np.abs(np.asarray(q)).max())
    for i in range(N):
        err = float(np.abs(padv[i].numpy() - np.asarray(adv[i])).max())
        assert err <= TOL * scale, f"counterfactual advantage of agent {i}: {err:.3g}"


def _cfg(**kw):
    base = dict(env_id=TINY, algo="coma", net="gnn", num_envs=2, hidden_dim=8, batch_size=6,
                coma_entropy_decay=0.9, device="cpu")
    base.update(kw)
    return run_rl.RLRunConfig(**base)


def _recording(tx, grads_out):
    """An optax transformation that records the gradients it is given."""
    def update(g, state, params=None):
        jax.debug.callback(lambda x: grads_out.append(jax.tree.map(np.array, x)), g)
        return tx.update(g, state, params)
    return optax.GradientTransformation(tx.init, update)


@pytest.fixture(scope="module")
def tiny():
    """Tiny params, JAX observations, one JAX COMA state (at step 3: the
    entropy coefficient anneals) and a batch for each of coordinated False
    and True."""
    jp, jl, pp, _ = both(TINY)
    obs = jax_observations(jp, jl, 3, 12, seed=3, every=1)  # (13, 3, A, D)
    jagent, _ = jax_agent(_cfg(), jp)
    jstate = jagent.init(jax.random.PRNGKey(7), jax_example_graph(jp, jax.random.PRNGKey(8)))
    jstate = jstate.replace(step=jnp.int32(3))
    batches = {c: _coma_batch(jp, jax_agent(_cfg(coordinated=c), jp)[0], jstate, obs, seed=5)
               for c in (False, True)}
    return jp, pp, obs, jstate, batches


def _coma_batch(jp, jagent, state, obs, seed):
    """A batch of B = 6 transitions from consecutive JAX observations, the
    actions drawn by JAX's own act (sampled, coordinated or not) under the
    state's actors, random rewards and dones."""
    rng = np.random.RandomState(seed)
    B = 6
    k, e = rng.randint(0, obs.shape[0] - 1, B), rng.randint(0, obs.shape[1], B)
    split = jax.vmap(lambda o: jh.split_observation(jp, o))
    cur, nxt = (tuple(np.asarray(x) for x in split(obs[k + d, e])) for d in (0, 1))
    feats = {"agv": cur[0], "picker": cur[1], "loc": cur[2]}
    scale = np.float32(1.0 / max(jp.grid_h, jp.grid_w))
    gs = lambda f: np.concatenate([x.reshape(B, -1) for x in f], 1) * scale

    def act(f, key):
        g = jh.build_hetero_graph(jp, f["agv"], f["picker"], f["loc"])
        m = jh.masks_from_feats(jp, f["agv"], f["picker"], f["loc"])
        return jagent.act(state, g, m, key, training=True,
                          active=~jcoord.busy_from_feats(f["agv"], f["picker"]))

    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    with HIGHEST:
        actions = np.asarray(jax.jit(jax.vmap(act))(feats, keys))
    return {"obs_feats": feats, "global_state": gs(cur), "actions": actions,
            "rewards": rng.randn(B).astype(np.float32),
            "next_global_state": gs(nxt), "dones": rng.rand(B) < 0.3}


UPDATE_CASES = [dict(coordinated=c, use_counterfactual=u) for c in (False, True)
                for u in (True, False)]


@pytest.mark.parametrize("case", UPDATE_CASES, ids=lambda c: "-".join(
    k for k, v in c.items() if v) or "plain")
def test_update_matches_jax(tiny, case):
    jp, pp, _, jstate, batches = tiny
    cfg = _cfg(coordinated=case["coordinated"])
    jagent, _ = jax_agent(cfg, jp)
    jagent.cfg = dataclasses.replace(jagent.cfg, use_counterfactual=case["use_counterfactual"])
    jgrads = {"actor": [], "critic": []}
    jagent.actor_tx = _recording(jagent.actor_tx, jgrads["actor"])
    jagent.critic_tx = _recording(jagent.critic_tx, jgrads["critic"])
    pagent, _ = run_rl.make_agent(cfg, pp)
    pagent.cfg = dataclasses.replace(pagent.cfg, use_counterfactual=case["use_counterfactual"])
    batch = batches[case["coordinated"]]
    with HIGHEST:
        jnew, jaux = jax.jit(jagent.update)(jstate, jax.tree.map(jnp.asarray, batch))
    jax.effects_barrier()
    pstate = port_agent_state(jstate, pagent)
    pnew, paux, pgrads = pagent.update_with_grads(pstate, jax.tree.map(_t, batch))

    for k in ("critic_loss", "actor_loss"):
        _close(paux[k], jaux[k], TOL, k)
    for part, names, jtree, new_p, old_p, opt, lr in (
            ("critic", pstate.critic_params, jnew.critic_params, pnew.critic_params,
             pstate.critic_params, pstate.critic_opt, pagent.cfg.lr_critic),
            ("actor", pstate.actor_params, jnew.actor_params, pnew.actor_params,
             pstate.actor_params, pstate.actor_opt, pagent.cfg.lr_actor)):
        jg = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jgrads[part][0]), "cpu")
        scale = max(float(v.abs().max()) for v in jg.values())
        for name in names:
            err = float((pgrads[part][name] - jg[name]).abs().max())
            assert err <= TOL * scale, f"{part} gradient {name}: {err:.3g} > {TOL} x {scale:.3g}"
        # Adam from the same (JAX's) gradients.
        from_jax, _ = adam_step(old_p, jg, opt, lr)
        want = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jtree), "cpu")
        for name in names:
            _close(from_jax[name], want[name], TOL, f"{part} {name} after Adam")
            assert new_p[name].shape == want[name].shape
    assert int(pnew.step) == int(jnew.step) == 4


def test_sequential_log_prob_gradient_matches_jax(tiny):
    jp, pp, obs, _, _ = tiny
    o = obs[5]  # (3, A, D)
    split = jax.jit(jax.vmap(lambda x: jh.split_observation(jp, x)))
    f = [np.asarray(x) for x in split(o)]
    masks = np.asarray(jax.jit(jax.vmap(lambda a, p, l: jh.masks_from_feats(jp, a, p, l)))(*f))
    active = ~np.asarray(jax.jit(jax.vmap(jcoord.busy_from_feats))(f[0], f[1]))
    rng = np.random.RandomState(2)
    logits = rng.randn(*masks.shape).astype(np.float32)
    w_lp = rng.randn(*masks.shape[:2]).astype(np.float32)
    w_ent = rng.randn(*masks.shape[:2]).astype(np.float32)
    rs = 1 + jp.num_goals
    keys = jax.random.split(jax.random.PRNGKey(4), o.shape[0])
    actions = np.asarray(jax.jit(jax.vmap(lambda lg, m, k, a: jcoord.coordinated_sample(
        lg, m, jp.num_agvs, rs, k, active=a)))(logits, masks, keys, active))

    def jloss(lg):
        lp, ent = jax.vmap(lambda x, m, a, ac: jcoord.sequential_log_prob(
            x, m, a, jp.num_agvs, rs, active=ac))(lg, masks, actions, active)
        return (lp * w_lp).sum() + (ent * w_ent).sum()

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(logits)
    x = _t(logits).requires_grad_(True)
    lp, ent = pcoord.sequential_log_prob(x, _t(masks), _t(actions), pp.num_agvs, rs,
                                         active=_t(active))
    loss = (lp * _t(w_lp)).sum() + (ent * _t(w_ent)).sum()
    (grad,) = torch.autograd.grad(loss, x)
    _close(loss.detach(), jval, 2e-6, "loss")
    _close(grad, jgrad, TOL, "gradient")
    assert float(jnp.abs(jgrad).max()) > 0


# run_marl(algo="coma"), coordinated, on tiny with 30-step episodes: two
# strides of 2 envs, 3 updates a stride.
STEPS = 30
LOOP = dict(env_id=TINY, algo="coma", net="gnn", num_envs=2, num_episodes=4, hidden_dim=8,
            buffer_size=200, batch_size=8, learn_every=5, coma_updates=3, coordinated=True,
            coma_entropy_decay=0.95, seed=0)


def _short(orig):
    return staticmethod(lambda env_id, **o: orig(env_id, **{"max_steps": STEPS, **o}))


def test_run_marl_coma_matches_jax_step_for_step(monkeypatch):
    monkeypatch.setattr(JEnvConfig, "from_env_id", _short(JEnvConfig.from_env_id))
    monkeypatch.setattr(PEnvConfig, "from_env_id", _short(PEnvConfig.from_env_id))
    items, jlosses, jinit = [], [], []
    add_batch, update, init = jreplay.add_batch, jrl_coma.COMAAgent.update, jrl_coma.COMAAgent.init

    def recording_add_batch(buf, it):
        jax.debug.callback(lambda x: items.append(jax.tree.map(np.array, x)), it, ordered=True)
        return add_batch(buf, it)

    def recording_update(self, state, batch):
        new, aux = update(self, state, batch)
        jax.debug.callback(lambda c, a: jlosses.append((float(c), float(a))),
                           aux["critic_loss"], aux["actor_loss"], ordered=True)
        return new, aux

    def recording_init(self, key, graph):
        jinit.append(init(self, key, graph))
        return jinit[-1]

    monkeypatch.setattr(jreplay, "add_batch", recording_add_batch)
    monkeypatch.setattr(jrl_coma.COMAAgent, "update", recording_update)
    monkeypatch.setattr(jrl_coma.COMAAgent, "init", recording_init)
    with HIGHEST:
        jout = jrun.run_marl(jrun.RLRunConfig(**LOOP), verbose=False)
    jax.effects_barrier()

    cfg = run_rl.RLRunConfig(**LOOP, device="cpu")
    jp, _, pp, _ = both(cfg.env_id, max_steps=STEPS)
    key = jax.random.PRNGKey(cfg.seed)
    key, _ = jax.random.split(key)  # the example graph's
    key, _ = jax.random.split(key)  # the agent's initialisation
    pagent, _ = run_rl.make_agent(cfg, pp)
    start = port_agent_state(jinit[0], pagent)
    plosses = []
    pupdate = pagent.update.__func__

    def port_recording(self, state, batch):
        new, aux = pupdate(self, state, batch)
        plosses.append((float(aux["critic_loss"]), float(aux["actor_loss"])))
        return new, aux

    monkeypatch.setattr(type(pagent), "update", port_recording)
    pout = run_rl.run_marl(cfg, verbose=False, draws=JaxMarlDraws(jp, key, True, "coma"),
                           agent_state=start)

    B = cfg.num_envs
    assert len(items) == 2 * STEPS
    storage = pout["buffer"].storage
    for t, it in enumerate(items):
        got = jax.tree.map(lambda s: s[t * B:(t + 1) * B].numpy(), storage)
        for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(it), jax.tree.leaves(got)):
            assert np.array_equal(g, want) and g.dtype == want.dtype, (t, path)
    assert len(plosses) == len(jlosses) == 6
    np.testing.assert_allclose(np.array(plosses), np.array(jlosses), rtol=1e-4, atol=1e-7)
    for ph, jh_ in zip(pout["history"], jout["history"]):
        for k in ("episode", "deliveries", "clashes", "stucks", "pick_rate"):
            assert ph[k] == jh_[k], k
        for k in ("return", "critic_loss", "actor_loss", "loss"):
            np.testing.assert_allclose(ph[k], jh_[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(pout["agent_state"].step) == int(jout["agent_state"].step) == 6


def test_coma_checkpoint_and_resume_restore_the_state_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(PEnvConfig, "from_env_id", _short(PEnvConfig.from_env_id))
    cfg = run_rl.RLRunConfig(**{**LOOP, "num_episodes": 2, "eval_every": 0,
                                "checkpoint_dir": str(tmp_path), "checkpoint_every": 2},
                             device="cpu")
    out = run_rl.run_marl(cfg, verbose=False)
    trained = out["agent_state"]
    res = run_rl.run_marl(dataclasses.replace(cfg, num_episodes=0, checkpoint_dir=None,
                                              resume_from=str(tmp_path)), verbose=False)
    st = res["agent_state"]
    assert res["history"][0]["episode"] == 2 and int(st.step) == 3
    for part in ("actor_params", "critic_params"):
        for name, v in getattr(trained, part).items():
            assert torch.equal(getattr(st, part)[name], v), name
    for opt in ("actor_opt", "critic_opt"):
        a, b = getattr(st, opt), getattr(trained, opt)
        assert torch.equal(a.count, b.count)
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))
