"""The port's env API against the JAX package's: the three observation
queries and the action masks under every flag combination, `WarehouseEnv`,
`rollout` and `auto_reset_rollout` with injected resets and draws, the
invariant checker, and the gym adapter, its wrappers, `make` and
`register_gym_envs` (mirroring tests/test_gym_adapter.py and
tests/test_wrappers_invariants.py)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import swarm_ode_tpu
import swarm_ode_tpu_torch
from swarm_ode_tpu.env import env as jenv
from swarm_ode_tpu.env import invariants as jinv
from swarm_ode_tpu.env import observations as jobs
from swarm_ode_tpu.env import step as jstep
from swarm_ode_tpu.policies import heuristic as jheur
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.config import EnvConfig as PEnvConfig
from swarm_ode_tpu_torch.env import env as penv
from swarm_ode_tpu_torch.env import invariants as pinv
from swarm_ode_tpu_torch.env import observations as pobs
from swarm_ode_tpu_torch.env import step as pstep
from swarm_ode_tpu_torch.policies import heuristic as pheur
from torch_port_helpers import (
    MEDIUM,
    TINY,
    assert_same,
    both,
    fields,
    jax_heuristic_init,
    jax_noise,
    jax_policy_fn,
    jax_reset_batch,
    jax_step_fn,
    numpy_dict,
    torch_dict,
)


def _port_state(js):
    return convert.env_state_from_numpy(fields(js), device="cpu")


def _trajectory(jp, jl, B, T, seed):
    """States of a JAX heuristic rollout (every step's)."""
    policy, step = jax_policy_fn(jp, jl), jax_step_fn(jp)
    js, jh = jax_reset_batch(jp, B, seed), jax_heuristic_init(jp, B)
    states = []
    for _ in range(T):
        ja, jh = policy(js, jh)
        js, _, _, _ = step(js, ja)
        states.append(js)
    return states


@pytest.mark.parametrize("env_id,B,T", [
    (TINY, 3, 40), (MEDIUM, 2, 25), ("tarware-small-5agvs-0pickers-globalobs-v1", 2, 25),
])
def test_queries_and_masks_match_jax(env_id, B, T):
    jp, jl, pp, _ = both(env_id)
    flags = list(itertools.product((True, False), (True, False)))
    jq = jax.jit(jax.vmap(lambda s: (
        jobs.shelf_request_info(jp, s), jobs.empty_shelf_info(jp, s),
        jobs.carrying_shelf_info(jp, s),
        *(jobs.compute_valid_action_masks(jp, s, a, b) for a, b in flags))))
    blocked = 0
    for t, js in enumerate(_trajectory(jp, jl, B, T, seed=3)):
        req, empty, carrying, *masks = (np.asarray(x) for x in jq(js))
        ps = _port_state(js)
        got = {"requested": pobs.shelf_request_info(pp, ps).numpy(),
               "empty": pobs.empty_shelf_info(pp, ps).numpy(),
               "carrying": pobs.carrying_shelf_info(pp, ps).numpy()}
        for (a, b), m in zip(flags, masks):
            got[f"masks {a} {b}"] = pobs.compute_valid_action_masks(pp, ps, a, b).numpy()
        want = {"requested": req, "empty": empty, "carrying": carrying,
                **{f"masks {a} {b}": m for (a, b), m in zip(flags, masks)}}
        assert_same(want, got, f"step {t}")
        blocked += int((masks[0] != masks[1]).sum())
    if pp.num_pickers:
        assert blocked > 0, "no conflicting action was ever blocked"


def test_warehouse_env_matches_jax():
    jp, jl, pp, pl = both(TINY)
    cfg = PEnvConfig.from_env_id(TINY)
    env = penv.WarehouseEnv(cfg, device="cpu")
    jwe = jenv.WarehouseEnv(swarm_ode_tpu.EnvConfig.from_env_id(TINY))
    states = _trajectory(jp, jl, 3, 12, seed=8)
    rng = np.random.default_rng(0)
    for t, js in enumerate(states[::3]):
        actions = rng.integers(0, pp.num_actions, size=(3, pp.num_agents)).astype(np.int32)
        noise, _ = jax_noise(jp, js.key)
        jo, js2, jr, jd, ji = jwe.step_batch(js, jnp.asarray(actions))
        po, ps2, pr, pd, pi = env.step_batch(_port_state(js), torch.from_numpy(actions),
                                             noise=noise)
        assert_same({"obs": np.asarray(jo), "rewards": np.asarray(jr), "done": np.asarray(jd)},
                    {"obs": po.numpy(), "rewards": pr.numpy(), "done": pd.numpy()}, f"{t}")
        assert_same(fields(js2), convert.env_state_to_numpy(ps2), f"{t} state")
        assert_same(numpy_dict(ji), torch_dict(pi), f"{t} info")
        want = np.asarray(jax.vmap(jwe.action_masks)(js))
        np.testing.assert_array_equal(env.action_masks(_port_state(js)).numpy(), want)
    g = torch.Generator().manual_seed(0)
    obs, s = env.reset(g)
    assert obs.shape == (1, pp.num_agents, max(pobs.obs_lengths(pp))) and s.batch == 1
    obs, s = env.reset_batch(4, g)
    assert obs.shape[0] == 4 and s.agent_xy.shape == (4, pp.num_agents, 2)
    pinv.check_state(pp, s)


def test_rollout_matches_jax():
    """`rollout` with the heuristic from JAX's reset states and JAX's draws
    gives JAX's vmapped rollout: every step's rewards, done and info, the
    final env and policy states."""
    jp, jl, pp, pl = both(TINY)
    B, T = 3, 30
    js0 = jax_reset_batch(jp, B, seed=4)
    policy = jheur.make_policy(jp, jl)
    run = jax.jit(jax.vmap(lambda s, h: jenv.rollout(jp, policy, h, s, T)))
    js_T, jh_T, (jr, jd, ji) = run(js0, jax_heuristic_init(jp, B))
    noise, keys = [], js0.key
    for _ in range(T):
        n, keys = jax_noise(jp, keys)
        noise.append(n)
    ps_T, ph_T, (pr, pd, pi) = penv.rollout(
        pp, pheur.make_policy(pp, pl), pheur.init_state(pp, B), _port_state(js0), T,
        noise=noise)
    assert_same({"rewards": np.asarray(jr), "done": np.asarray(jd)},
                {"rewards": pr.numpy(), "done": pd.numpy()}, "traj")
    assert_same(numpy_dict(ji), torch_dict(pi), "info")
    assert_same(fields(js_T), convert.env_state_to_numpy(ps_T), "final state")
    assert_same(fields(jh_T), convert.heuristic_state_to_numpy(ph_T), "final h")
    assert int(pi["shelf_deliveries"].sum()) > 0


def test_auto_reset_rollout_matches_jax():
    """Episodes of 12 steps over 30: the port's auto-reset rollout, given
    JAX's fresh resets and JAX's step draws, restarts where JAX's does and
    equals it step for step (JAX's test: exactly two boundaries per env,
    cur_steps counted from the last one)."""
    max_steps, T, B = 12, 30, 2
    jp, jl, pp, pl = both(TINY, max_steps=max_steps)
    policy = jheur.make_policy(jp, jl)
    js0 = jax_reset_batch(jp, B, seed=6)
    rkeys = jax.random.split(jax.random.PRNGKey(9), B)

    def one(es, key):
        h = jheur.init_state(jp)
        return jenv.auto_reset_rollout(jp, policy, lambda: jheur.init_state(jp), es, h, T, key)

    js_T, jh_T, _, (jr, jd, ji) = jax.jit(jax.vmap(one))(js0, rkeys)
    jd = np.asarray(jd)
    # The same draws for the port: the step's from each env's key chain, a
    # fresh reset from the rollout key's chain, the key restarting where done.
    reset = jax.jit(jax.vmap(lambda k: jstep.reset(jp, k)))
    split = jax.jit(jax.vmap(jax.random.split))
    env_keys, noise, fresh = js0.key, [], []
    for t in range(T):
        n, env_keys = jax_noise(jp, env_keys)
        noise.append(n)
        pair = split(rkeys)
        rkeys, sub = pair[:, 0], pair[:, 1]
        new = reset(sub)
        fresh.append(_port_state(new))
        env_keys = jnp.where(jd[:, t, None], new.key, env_keys)
    ps_T, ph_T, (pr, pd, pi) = penv.auto_reset_rollout(
        pp, pheur.make_policy(pp, pl), lambda b: pheur.init_state(pp, b), _port_state(js0),
        pheur.init_state(pp, B), T, noise=noise, fresh=fresh)
    assert_same({"rewards": np.asarray(jr), "done": jd},
                {"rewards": pr.numpy(), "done": pd.numpy()}, "traj")
    assert_same(numpy_dict(ji), torch_dict(pi), "info")
    assert_same(fields(js_T), convert.env_state_to_numpy(ps_T), "final state")
    assert_same(fields(jh_T), convert.heuristic_state_to_numpy(ph_T), "final h")
    assert (pd.sum(1) == 2).all()
    last = T - 1 - np.argmax(jd[:, ::-1], axis=1)
    np.testing.assert_array_equal(ps_T.cur_steps.numpy(), T - (last + 1))


def test_auto_reset_rollout_draws_from_generator():
    """Without injected draws the fresh states come from the generator: two
    boundaries per env, and the envs restart at step 0."""
    _, _, pp, pl = both(TINY, max_steps=10)
    g = torch.Generator().manual_seed(2)
    B = 3
    s, h, (r, d, info) = penv.auto_reset_rollout(
        pp, pheur.make_policy(pp, pl), lambda b: pheur.init_state(pp, b),
        pstep.reset(pp, B, g), pheur.init_state(pp, B), 25, generator=g)
    assert d.shape == (B, 25) and (d.sum(1) == 2).all()
    assert (s.cur_steps == 5).all() and (h.timestep == 5).all()


def _jax_check_message(jp, js_one):
    err, _ = checkify.checkify(lambda s: jinv.check_state(jp, s))(js_one)
    return err.get()


def test_check_state_passes_on_rollout_and_raises_on_broken_states():
    jp, jl, pp, pl = both(TINY)
    states = _trajectory(jp, jl, 2, 30, seed=2)
    check = pinv.checked_step(pp)
    for js in states[::5]:
        pinv.check_state(pp, _port_state(js))
    g = torch.Generator().manual_seed(0)
    s = pstep.reset(pp, 2, g)
    for _ in range(10):
        s, *_ = check(s, torch.zeros(2, pp.num_agents, dtype=torch.int32), generator=g)

    js = states[-1]
    base = {k: np.array(v) for k, v in fields(js).items()}
    # Two shelves on one cell (both on the grid), in env 1.
    two = {k: v.copy() for k, v in base.items()}
    carried = set(two["agent_carrying"][1].tolist())
    a, b = [i for i in range(pp.num_shelves) if i + 1 not in carried][:2]
    two["shelf_xy"][1, b] = two["shelf_xy"][1, a]
    # A duplicate queue entry, in env 0.
    dup = {k: v.copy() for k, v in base.items()}
    dup["request_queue"][0, 1] = dup["request_queue"][0, 0]
    for broken, msg, env in ((two, "two shelves on one cell", 1),
                             (dup, "duplicate request queue entries", 0)):
        one = type(js)(**{k: jnp.asarray(v[env]) for k, v in broken.items()})
        assert msg in _jax_check_message(jp, one)
        with pytest.raises(pinv.InvariantError, match=msg) as e:
            pinv.check_state(pp, convert.env_state_from_numpy(broken, device="cpu"))
        assert f"(envs [{env}])" in str(e.value)


# ---- the gym adapter (tests/test_gym_adapter.py on the port) ----

@pytest.fixture(scope="module")
def genv():
    return swarm_ode_tpu_torch.make(TINY, device="cpu")


def test_gym_reset_returns_bare_obs_tuple(genv):
    out = genv.reset(seed=0)
    assert isinstance(out, tuple) and len(out) == genv.num_agents
    assert all(isinstance(o, np.ndarray) and o.dtype == np.float32 for o in out)
    assert [o.shape[0] for o in out] == [s.shape[0] for s in genv.observation_space]


def test_gym_step_returns_terminateds_twice(genv):
    genv.reset(seed=0)
    obs, rew, term, trunc, info = genv.step([0] * genv.num_agents)
    assert term == trunc and len(term) == genv.num_agents and len(rew) == genv.num_agents
    assert isinstance(info["shelf_deliveries"], int)
    assert isinstance(info["vehicles_busy"], list)


def test_gym_episode_terminates_at_max_steps():
    env = swarm_ode_tpu_torch.make(TINY, device="cpu", max_steps=40)
    env.reset(seed=1)
    for t in range(env.params.max_steps):
        obs, rew, term, trunc, info = env.step([0] * env.num_agents)
        assert all(term) == (t == env.params.max_steps - 1)


def test_gym_layout_attributes_match_jax(genv):
    jenv_ = swarm_ode_tpu.make(TINY)
    assert genv.action_id_to_coords_map == jenv_.action_id_to_coords_map
    assert genv.rack_groups == jenv_.rack_groups
    assert genv.goals == jenv_.goals and genv.grid_size == jenv_.grid_size
    assert genv.action_space == jenv_.action_space
    assert genv.observation_space == jenv_.observation_space
    m = genv.action_id_to_coords_map
    assert sorted(m.keys()) == list(range(1, genv.action_size))
    assert all(y == genv.grid_size[0] - 1 for (x, y) in genv.goals)


def test_gym_request_queue_shelf_views(genv):
    genv.reset(seed=2)
    rq = genv.request_queue
    assert len(rq) == genv.params.request_queue_size
    for s in rq:
        assert 1 <= s.id <= genv.params.num_shelves
        assert not genv.layout.highway[s.y, s.x]


def test_gym_masks_and_info_queries_match_the_functions(genv):
    genv.reset(seed=3)
    for _ in range(15):
        genv.step(np.arange(genv.num_agents) + 2)
    s = genv.state
    for a, b in itertools.product((True, False), (True, False)):
        m = genv.compute_valid_action_masks(a, b)
        assert m.shape == (genv.num_agents, genv.action_size)
        np.testing.assert_array_equal(m, pobs.compute_valid_action_masks(genv.params, s, a, b)[0])
    req = genv.get_shelf_request_information()
    empty = genv.get_empty_shelf_information()
    assert req.shape == (genv.params.num_racks,) and not np.any((req > 0) & (empty > 0))
    assert genv.get_carrying_shelf_information() == (s.agent_carrying[0, :3] > 0).tolist()


def test_gym_seeded_resets_repeat_and_unseeded_differ():
    env = swarm_ode_tpu_torch.make(TINY, device="cpu")
    a = [o.copy() for o in env.reset(seed=5)]
    b = env.reset()
    c = env.reset(seed=5)
    assert all(np.array_equal(x, y) for x, y in zip(a, c))
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))


def test_heuristic_episode_function(genv):
    infos, global_ret, ep_returns = pheur.heuristic_episode(genv, seed=0)
    assert len(infos) == genv.params.max_steps
    assert ep_returns.shape == (genv.num_agents,) and ep_returns.dtype == np.float32
    assert sum(i["shelf_deliveries"] for i in infos) > 3
    assert abs(global_ret - ep_returns.sum()) < 1e-3
    jax_env = swarm_ode_tpu.make(TINY)
    jax_env.reset(seed=0)
    assert set(infos[0]) == set(jax_env.step([0] * 5)[4])
    short = swarm_ode_tpu_torch.make(TINY, device="cpu", max_steps=5)
    n = pheur.heuristic_episode._unseeded_counter
    pheur.heuristic_episode(short)
    assert pheur.heuristic_episode._unseeded_counter == n + 1


# ---- wrappers (tests/test_wrappers_invariants.py on the port) ----

def test_flatten_agents(genv):
    from swarm_ode_tpu_torch.env.wrappers import FlattenAgents

    w = FlattenAgents(genv)
    obs = w.reset(seed=0)
    total = sum(int(np.prod(s.shape)) for s in genv.observation_space)
    assert obs.ndim == 1 and obs.shape == (total,)
    obs, rew, term, trunc, info = w.step(np.zeros(5, np.int64))
    assert np.ndim(rew) == 0 and isinstance(term, (bool, np.bool_))


def test_dict_agents(genv):
    from swarm_ode_tpu_torch.env.wrappers import DictAgents

    w = DictAgents(genv)
    obs = w.reset(seed=0)
    assert sorted(obs.keys()) == [f"agent_{i}" for i in range(5)]
    obs, rew, term, trunc, info = w.step({k: 0 for k in obs})
    assert "__all__" in trunc


def test_squash_dones_and_flatten_sa(genv):
    from swarm_ode_tpu_torch.env.wrappers import FlattenSAObservation, SquashDones

    w = SquashDones(genv)
    w.reset(seed=0)
    obs, rew, term, trunc, info = w.step([0] * 5)
    assert isinstance(term, (bool, np.bool_))
    f = FlattenSAObservation(genv)
    assert len(f.observation(genv.reset(seed=0))) == 5


# ---- make and register_gym_envs ----

def test_make_and_register_gym_envs():
    import gymnasium as gym

    env = swarm_ode_tpu_torch.make(MEDIUM, device="cpu", max_steps=7)
    assert env.num_agents == 28 and env.params.max_steps == 7
    assert env.params.device.type == "cpu"
    before = dict(gym.registry)
    try:
        swarm_ode_tpu_torch.register_gym_envs()
        spec = gym.spec(TINY)
        assert spec.entry_point == "swarm_ode_tpu_torch.env.gym_adapter:Warehouse"
        made = gym.make(TINY, device="cpu", disable_env_checker=True).unwrapped
        assert type(made).__module__ == "swarm_ode_tpu_torch.env.gym_adapter"
        assert len(made.reset(seed=0)) == 5
    finally:
        gym.registry.clear()
        gym.registry.update(before)
        swarm_ode_tpu_torch._REGISTERED = False


def test_register_gym_envs_refuses_ids_taken_by_jax():
    """The two packages register the same ids: once the JAX package owns
    them, the port's registration raises rather than take them over."""
    import gymnasium as gym

    import swarm_ode_tpu

    before = dict(gym.registry)
    jax_registered = swarm_ode_tpu._REGISTERED
    try:
        gym.register(id=TINY, entry_point="swarm_ode_tpu.env.gym_adapter:Warehouse")
        with pytest.raises(RuntimeError, match="mutually exclusive"):
            swarm_ode_tpu_torch.register_gym_envs()
        assert gym.spec(TINY).entry_point == "swarm_ode_tpu.env.gym_adapter:Warehouse"
        assert not swarm_ode_tpu_torch._REGISTERED
    finally:
        gym.registry.clear()
        gym.registry.update(before)
        swarm_ode_tpu._REGISTERED = jax_registered
        swarm_ode_tpu_torch._REGISTERED = False


def test_render_matches_jax():
    """The renderer copy draws the port's state (one env read back to the
    host) as JAX's draws the same state: the same pixels."""
    from swarm_ode_tpu.env.rendering import render_state as jrender
    from swarm_ode_tpu_torch.env.rendering import render_state as prender

    jp, jl, pp, pl = both(TINY)
    js = _trajectory(jp, jl, 2, 20, seed=1)[-1]
    want = jrender(jp, jl, jax.tree.map(lambda x: x[1], js), mode="rgb_array")
    got = prender(pp, pl, _port_state(js), mode="rgb_array", index=1)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
