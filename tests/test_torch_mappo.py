"""MAPPO in the port against the JAX package's rl/ppo.py on tiny (2 envs,
16-step strides, gnn actor): JAX's run_mappo runs one stride, its jitted
collection and update are watched (their inputs and outputs recorded), and
the port repeats both from the same parameters: the collection on JAX's
own draws (resets, step draws, the auction's Gumbels) with the actions
and active flags bit for bit and logp, global states, advantages and
returns within 1e-5; the update on JAX's trajectory with JAX's
permutations, its losses and the parameters after it within 1e-5 (JAX at
HIGHEST); the greedy probe after the update, on JAX's resets and step
draws, with the same mean return and deliveries. Then the warm start from
a behaviour-cloning checkpoint, the stride checkpoint, and mesh_devices'
checks (tests/test_torch_mesh.py runs it on several ranks)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.rl import ppo as jppo
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.rl import ppo as pppo
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager
from torch_port_helpers import TINY, both, fields, jax_noise

HIGHEST = jax.default_matmul_precision("highest")
CFG = dict(env_id=TINY, net="gnn", hidden_dim=8, critic_hidden=16, num_envs=2, num_strides=1,
           steps_override=16, minibatch=8, ppo_epochs=2, lr=3e-3, lr_critic=3e-3, seed=2,
           eval_every=1, eval_episodes=2)


@pytest.fixture(scope="module")
def jax_stride():
    """JAX's run_mappo for one stride, its jitted functions' inputs and
    outputs recorded by name."""
    calls = {}
    real_jit = jax.jit

    def watching_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        name = getattr(fn, "__name__", "")

        def call(*a):
            out = jitted(*a)
            calls.setdefault(name, []).append((a, out))
            return out

        return call

    with pytest.MonkeyPatch.context() as mp, HIGHEST:
        mp.setattr(jax, "jit", watching_jit)
        out = jppo.run_mappo(jppo.MAPPOConfig(**CFG), verbose=False)
    return calls, out


def _np(x):
    return np.asarray(x)


class _JaxCollectDraws:
    """The draws of JAX's MAPPO collection from its key: kr, key =
    split(key) (resets per split(kr, B)); the step keys split(key, T); at
    step t the auction's Gumbels per split(key_t, B); the env's draws from
    the envs' own state keys."""

    def __init__(self, jp, key, T):
        from swarm_ode_tpu.env import step as jstep

        self.jp, self.t, self.jstep = jp, 0, jstep
        self.kr, key = jax.random.split(key)
        self.step_keys = jax.random.split(key, T)
        A, n = jp.num_agents, jp.num_actions
        self._gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (A, n))))

    def reset(self, B):
        js = jax.jit(jax.vmap(lambda k: self.jstep.reset(self.jp, k)))(
            jax.random.split(self.kr, B))
        self.env_keys = js.key
        return convert.env_state_from_numpy(fields(js), device="cpu")

    def gumbel(self, B):
        return torch.from_numpy(np.array(self._gumbel(jax.random.split(self.step_keys[self.t],
                                                                      B))))

    def step(self, B):
        noise, self.env_keys = jax_noise(self.jp, self.env_keys)
        self.t += 1
        return noise


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max error {err:.3g} > {tol} x {scale:.3g}"


def _run_from(jparams_tree, jcritic_tree):
    """A port MappoRun of CFG on the CPU holding JAX's parameters."""
    run = pppo.MappoRun(pppo.MAPPOConfig(**CFG, device="cpu"))
    run.actor_params, run.critic_params = convert.mappo_params_from_numpy(
        jax.tree.map(_np, jparams_tree), jax.tree.map(_np, jcritic_tree),
        list(run.actor_params), list(run.critic_params), device="cpu")
    return run


def test_collection_matches_jax(jax_stride):
    calls, _ = jax_stride
    ((ap, cp, key), want), = calls["collect_impl"]
    jp, _, _, _ = both(TINY)
    run = _run_from(ap, cp)
    got = run.collect(_JaxCollectDraws(jp, key, CFG["steps_override"]))
    for k in ("actions", "active", "deliv"):
        assert got[k].numpy().dtype == _np(want[k]).dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["obs"], want["obs"])
    for k in ("gs", "logp", "reward", "adv", "ret"):
        _close(got[k], want[k], 1e-5, k)
    # The values behind the advantages: ret - adv.
    _close(got["ret"] - got["adv"], _np(want["ret"]) - _np(want["adv"]), 1e-5, "values")
    assert got["actions"].shape == (16, 2, jp.num_agents)


def test_update_matches_jax(jax_stride):
    calls, _ = jax_stride
    ((ap, cp, ao, co, traj, key), (ap2, cp2, _, _, aux)), = calls["update"]
    run = _run_from(ap, cp)
    N = CFG["steps_override"] * CFG["num_envs"]
    perms = [torch.from_numpy(np.array(jax.random.permutation(k, N)))
             for k in jax.random.split(key, CFG["ppo_epochs"])]
    got = run.update({k: torch.from_numpy(np.array(v)) for k, v in traj.items()}, perms=perms)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(aux[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want_a, want_c = convert.mappo_params_from_numpy(jax.tree.map(_np, ap2),
                                                     jax.tree.map(_np, cp2), device="cpu")
    for mine, want, what in ((run.actor_params, want_a, "actor"),
                             (run.critic_params, want_c, "critic")):
        for name, w in want.items():
            _close(mine[name], w, 1e-5, f"{what} {name}")
    assert int(run.actor_opt.count) == int(run.critic_opt.count) == 2 * (N // CFG["minibatch"])


def test_greedy_probe_matches_jax(jax_stride):
    calls, _ = jax_stride
    ((ap, key), want), = calls["eval_probe"]
    jp, _, _, _ = both(TINY)
    run = _run_from(ap, calls["update"][0][1][1])
    got = run.eval_probe(_JaxCollectDraws(jp, key, CFG["steps_override"]))
    np.testing.assert_allclose(np.array(got), np.array([float(w) for w in want]), rtol=1e-5,
                               atol=1e-6)


def test_warm_start_and_stride_checkpoint(tmp_path):
    """init_from loads a behaviour-cloning checkpoint into the actor bit for
    bit; run_mappo's stride checkpoint holds the actor and the critic."""
    cfg = pppo.MAPPOConfig(**{**CFG, "steps_override": 8}, device="cpu")
    clone = {k: torch.randn_like(v) for k, v in pppo.MappoRun(cfg).actor_params.items()}
    CheckpointManager(str(tmp_path / "bc")).save(3, {"q_params": clone})
    warm = dataclasses.replace(cfg, init_from=str(tmp_path / "bc"),
                               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    run = pppo.MappoRun(warm)
    assert all(torch.equal(run.actor_params[k], v) for k, v in clone.items())
    out = pppo.run_mappo(warm, verbose=False, run=run)
    h = out["history"][0]
    assert np.isfinite([h["pg_loss"], h["v_loss"], h["entropy"]]).all()
    saved = CheckpointManager(str(tmp_path / "ck")).restore(
        {"q_params": out["actor_params"], "critic": out["critic_params"]})
    for part, key in (("actor_params", "q_params"), ("critic_params", "critic")):
        assert all(torch.equal(saved[key][k], v) for k, v in out[part].items())
    with pytest.raises(FileNotFoundError):
        pppo.MappoRun(dataclasses.replace(cfg, init_from=str(tmp_path / "none")))


def test_mesh_devices_raise():
    """mesh_devices raises JAX's ValueError where num_envs does not divide
    over it, and where the process group does not have that many ranks (no
    group here: one rank); mesh_devices=1 runs on the one rank."""
    with pytest.raises(ValueError, match="num_envs=2 must divide over mesh_devices=3"):
        pppo.MappoRun(pppo.MAPPOConfig(**CFG, mesh_devices=3, device="cpu"))
    with pytest.raises(ValueError, match="mesh_devices=2 needs a process group"):
        pppo.MappoRun(pppo.MAPPOConfig(**CFG, mesh_devices=2, device="cpu"))
    assert pppo.MappoRun(pppo.MAPPOConfig(**CFG, mesh_devices=1, device="cpu")).mesh.size == 1
