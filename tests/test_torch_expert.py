"""The port's stochastic and stateless heuristic experts against the JAX
package's, bit for bit: `_sampled_argmin` on the same Gumbel draws, the
stochastic dispatcher's actions and state with JAX's own draws, and
`reconstruct_state` and the stateless expert along the threaded expert's
trajectory. Then the stateless expert in closed loop on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.policies import heuristic as jheur
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.env import env as penv
from swarm_ode_tpu_torch.env import step as pstep
from swarm_ode_tpu_torch.policies import heuristic as pheur
from torch_port_helpers import (
    MEDIUM,
    TINY,
    assert_same,
    both,
    fields,
    jax_dispatch_noise,
    jax_heuristic_init,
    jax_policy_fn,
    jax_reset_batch,
    jax_step_fn,
)


def _port_state(js):
    return convert.env_state_from_numpy(fields(js), device="cpu")


@pytest.mark.parametrize("temperature", [1.0, 1e-3, 0.37])
def test_sampled_argmin_matches_jax(temperature):
    rng = np.random.default_rng(3)
    d = rng.integers(0, 40, size=(64, 23)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = 1 << 28  # INF32: invalid entries
    d[5] = 1 << 28  # a row with no valid entry
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, d.shape[0])
    want = jax.vmap(lambda dd, k: jheur._sampled_argmin(dd, k, temperature))(jnp.asarray(d), keys)
    g = jax.vmap(lambda k: jax.random.gumbel(k, (d.shape[1],)))(keys)
    got = pheur._sampled_argmin(torch.from_numpy(d), torch.from_numpy(np.asarray(g).copy()),
                                temperature)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_argmin_ties_match_jax():
    """JAX's tie case (tests/test_heuristic.py): at T << 1 only exact ties
    are randomised, and both ties get sampled, index for index as JAX."""
    d = jnp.asarray([5.0, 3.0, 3.0, 9.0, jnp.inf])
    picks = set()
    for s in range(20):
        key = jax.random.PRNGKey(s)
        want = int(jheur._sampled_argmin(d, key, 1e-3))
        g = torch.from_numpy(np.asarray(jax.random.gumbel(key, d.shape)).copy())
        got = int(pheur._sampled_argmin(torch.from_numpy(np.array(d)), g, 1e-3))
        assert got == want and float(d[got]) == 3.0
        picks.add(got)
    assert picks == {1, 2}


@pytest.mark.parametrize("env_id,B,T,temperature", [
    (TINY, 4, 40, 1.0),
    (TINY, 4, 40, 1e-3),
    (MEDIUM, 2, 40, 1.0),
])
def test_stochastic_dispatcher_matches_jax(env_id, B, T, temperature):
    """Along a JAX trajectory of the stochastic dispatcher: the port's
    actions and HeuristicState equal JAX's at every step, given JAX's
    draws."""
    jp, jl, pp, pl = both(env_id)
    jpolicy = jheur.make_policy(jp, jl, temperature=temperature)
    policy = jax.jit(jax.vmap(lambda s, h, k: jpolicy(jp, s, h, k)))
    step = jax_step_fn(jp)
    port_policy = pheur.make_policy(pp, pl, temperature=temperature)
    js = jax_reset_batch(jp, B, seed=13)
    jh = jax_heuristic_init(jp, B)
    keys = jax.random.split(jax.random.PRNGKey(temperature > 0.5), T * B).reshape(T, B, -1)
    differs = 0
    for t in range(T):
        ph = convert.heuristic_state_from_numpy(fields(jh), device="cpu")
        det, _ = pheur.make_policy(pp, pl)(
            pp, _port_state(js), convert.heuristic_state_from_numpy(fields(jh), "cpu"))
        pa, ph = port_policy(pp, _port_state(js), ph, jax_dispatch_noise(jp, keys[t]))
        ja, jh = policy(js, jh, keys[t])
        assert_same({"actions": np.asarray(ja)}, {"actions": pa.numpy()}, f"step {t}")
        assert_same(fields(jh), convert.heuristic_state_to_numpy(ph), f"step {t} h")
        differs += int((pa != det).sum())
        js, _, _, _ = step(js, ja)
    if temperature >= 1.0:
        assert differs > 0, "the draws never changed a choice"


def test_stochastic_rollout_draws_from_generator():
    """At temperature > 0 the policy step draws the dispatcher's noise from a
    generator passed in its place: two seeds diverge, one seed repeats,
    deliveries happen."""
    _, _, pp, pl = both(TINY)
    policy = pheur.make_policy(pp, pl, temperature=1.0)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        es, h = pstep.reset(pp, 2, g), pheur.init_state(pp, 2)
        acts, deliveries = [], 0
        for _ in range(60):
            a, h = policy(pp, es, h, g)
            es, _, _, info = pstep.step(pp, es, a, generator=g)
            acts.append(a)
            deliveries += int(info["shelf_deliveries"].sum())
        return torch.stack(acts), deliveries

    (a, da), (b, _), (c, _) = run(3), run(4), run(3)
    assert torch.equal(a, c) and not torch.equal(a, b)
    assert da > 0


def _jax_expert_trajectory(jp, jl, B, T, seed):
    """States of the threaded JAX expert's own trajectory, with its actions."""
    policy, step = jax_policy_fn(jp, jl), jax_step_fn(jp)
    js, jh = jax_reset_batch(jp, B, seed), jax_heuristic_init(jp, B)
    states, actions = [], []
    for _ in range(T):
        ja, jh = policy(js, jh)
        states.append(js)
        actions.append(np.asarray(ja))
        js, _, _, _ = step(js, ja)
    return states, actions


def _carrier_on_rack(jp, js) -> int:
    """Envs where a carried shelf stands on a rack cell that holds another
    shelf: reconstruct_state's scatter writes that cell twice."""
    sxy = np.asarray(js.shelf_xy)
    c2r = np.asarray(jp.cell_to_rack)
    n = 0
    for b in range(sxy.shape[0]):
        racks = c2r[sxy[b, :, 1], sxy[b, :, 0]]
        cells = racks[racks >= 0]
        n += int(len(cells) != len(np.unique(cells)))
    return n


@pytest.mark.parametrize("env_id,B,T", [(TINY, 3, 120), (MEDIUM, 2, 40)])
def test_reconstruct_state_and_stateless_expert_match_jax(env_id, B, T):
    """At every state of the threaded expert's trajectory the port's
    reconstruct_state equals JAX's field by field and the port's stateless
    expert gives JAX's stateless actions exactly."""
    jp, jl, pp, pl = both(env_id)
    jrec = jax.jit(jax.vmap(lambda s: jheur.reconstruct_state(jp, s)))
    jexpert = jheur.make_stateless_expert(jp, jl)
    jfree = jax.jit(jax.vmap(lambda s: jexpert(jp, s)))
    expert = pheur.make_stateless_expert(pp, pl)
    states, threaded = _jax_expert_trajectory(jp, jl, B, T, seed=5)
    agree, doubled = [], 0
    for t, js in enumerate(states):
        ps = _port_state(js)
        assert_same(fields(jrec(js)),
                    convert.heuristic_state_to_numpy(pheur.reconstruct_state(pp, ps)),
                    f"step {t} reconstruct_state")
        ja = np.asarray(jfree(js))
        assert_same({"actions": ja}, {"actions": expert(pp, ps).numpy()}, f"step {t}")
        agree.append((ja == threaded[t]).mean())
        doubled += _carrier_on_rack(jp, js)
    assert np.mean(agree) > 0.9
    if env_id == TINY:
        assert doubled > 0, "no state wrote a rack cell twice"


def test_reconstruct_state_doubled_rack_cell_matches_jax():
    """A carrier on a rack cell that holds another shelf, with an AGV heading
    to pick at that cell: both packages keep the higher shelf id there."""
    jp, jl, pp, pl = both(TINY)
    js = jax_reset_batch(jp, 2, seed=1)
    f = {k: np.array(v) for k, v in fields(js).items()}
    G = jp.num_goals
    c2r = np.asarray(jp.cell_to_rack)
    for b, (low, high) in enumerate([(3, 9), (9, 3)]):
        # shelf `low` stays on its spawn cell; agent 1 carries `high` there.
        x, y = f["shelf_xy"][b, low - 1]
        rack = int(c2r[y, x])
        f["shelf_xy"][b, high - 1] = (x, y)
        f["agent_carrying"][b, 1] = high
        f["agent_busy"][b, 0] = True
        f["agent_target"][b, 0] = G + 1 + rack
    want = jax.vmap(lambda s: jheur.reconstruct_state(jp, s))(
        type(js)(**{k: jnp.asarray(v) for k, v in f.items()}))
    got = pheur.reconstruct_state(pp, convert.env_state_from_numpy(f, device="cpu"))
    assert_same(fields(want), convert.heuristic_state_to_numpy(got), "doubled cell")
    assert got.agv_item[:, 0].tolist() == [9, 9]


def test_stateless_expert_closed_loop_quality():
    """Driving the env with per-step reconstruction loses (almost) no
    deliveries against the threaded dispatcher, from the same resets with
    the same step draws (JAX's test, on the port)."""
    _, _, pp, pl = both(TINY)
    B, T = 4, 200
    g = torch.Generator().manual_seed(1)
    start = pstep.reset(pp, B, g)
    noise = [pstep.draw_noise(pp, B, g) for _ in range(T)]
    threaded = pheur.heuristic_rollout(pp, pl, B, T, state=start, noise=noise)
    expert = pheur.make_stateless_expert(pp, pl)
    _, _, (_, _, info) = penv.rollout(
        pp, lambda p, s, h: (expert(p, s), h), None, start, T, noise=noise
    )
    ds, df = int(threaded.deliveries.sum()), int(info["shelf_deliveries"].sum())
    assert ds > 0 and df >= 0.9 * ds, f"stateless {df} vs stateful {ds} deliveries"


def test_make_policy_stochastic_signature():
    """temperature > 0 needs the step's draws: a DispatchNoise or a
    generator; without them the dispatcher raises."""
    _, _, pp, pl = both(TINY)
    s = pstep.reset(pp, 2, torch.Generator().manual_seed(0))
    h = pheur.init_state(pp, 2)
    with pytest.raises(ValueError):
        pheur.heuristic_policy(pp, torch.zeros(pp.num_racks, dtype=torch.int32), s, h,
                               temperature=1.0)
    step = pheur.make_policy(pp, pl, temperature=1.0)
    a1, _ = step(pp, s, h, torch.Generator().manual_seed(7))
    n = pheur.draw_dispatch_noise(pp, 2, torch.Generator().manual_seed(7))
    a2, _ = step(pp, s, h, n)
    assert torch.equal(a1, a2)
    assert n.assign.shape == (2, pp.request_queue_size, pp.num_agvs)
    assert n.goal.shape == (2, pp.num_agvs, pp.num_goals)
    assert n.ret.shape == (2, pp.num_agvs, pp.num_racks)
