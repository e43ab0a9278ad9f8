"""The ported slice as a whole: dispatcher + step for 40 medium steps at
B = 3, against a jitted, vmapped JAX scan from the same reset states with
the same draws. Integers and float rewards are compared exactly: rewards
are sums of the same float32 constants in the same order."""
import jax
import numpy as np
import torch

from swarm_ode_tpu.env import step as jstep
from swarm_ode_tpu.policies import heuristic as jheur
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout
from torch_port_helpers import (
    MEDIUM,
    assert_same,
    both,
    fields,
    jax_heuristic_init,
    jax_noise,
    jax_reset_batch,
    numpy_dict,
    torch_dict,
)

B, T = 3, 40


def _jax_scan(jp, jl, js0):
    policy = jheur.make_policy(jp, jl)

    def one(es, h):
        def body(carry, _):
            es, h = carry
            a, h = policy(jp, es, h)
            es, rew, done, info = jstep.step(jp, es, a)
            return (es, h), (a, rew, done, info, es)

        return jax.lax.scan(body, (es, h), None, length=T)

    return jax.jit(jax.vmap(one))(js0, jax_heuristic_init(jp, B))


def test_rollout_matches_jax_scan():
    jp, jl, pp, pl = both(MEDIUM)
    js0 = jax_reset_batch(jp, B, seed=21)
    (js_T, jh_T), (ja, jr, jdone, jinfo, jstates) = _jax_scan(jp, jl, js0)

    # The JAX step's draws depend only on the key chain, not on the state.
    noise, keys = [], js0.key
    for _ in range(T):
        n, keys = jax_noise(jp, keys)
        noise.append(n)
    np.testing.assert_array_equal(np.asarray(keys), np.asarray(js_T.key))

    out = heuristic_rollout(
        pp, pl, B, T, state=convert.env_state_from_numpy(fields(js0), device="cpu"), noise=noise,
        record=True,
    )
    for t, (actions, rewards, info, state) in enumerate(out.trace):
        step_t = jax.tree.map(lambda a: np.asarray(a)[:, t], jstates)
        assert_same(fields(step_t), convert.env_state_to_numpy(state), f"step {t} state")
        assert_same(
            {"actions": np.asarray(ja)[:, t], "rewards": np.asarray(jr)[:, t]},
            {"actions": actions.numpy(), "rewards": rewards.numpy()},
            f"step {t}",
        )
        assert_same(
            {k: v[:, t] for k, v in numpy_dict(jinfo).items()}, torch_dict(info),
            f"step {t} info",
        )
    assert_same(fields(js_T), convert.env_state_to_numpy(out.state), "final state")
    assert_same(fields(jh_T), convert.heuristic_state_to_numpy(out.heuristic), "final h")
    np.testing.assert_array_equal(
        out.deliveries.numpy(), np.asarray(jinfo["shelf_deliveries"]).sum(1)
    )
    np.testing.assert_array_equal(out.clashes.numpy(), np.asarray(jinfo["clashes"]).sum(1))
    assert int(out.deliveries.sum()) > 0 and int(out.replan_overflow.sum()) == 0


def test_rollout_draws_from_generator():
    """Without explicit noise the rollout draws from the generator: the same
    seed gives the same episode, another seed another one."""
    _, _, pp, pl = both(MEDIUM)

    def run(seed):
        return heuristic_rollout(pp, pl, 2, 25, torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a.state.agent_xy, b.state.agent_xy)
    assert torch.equal(a.deliveries, b.deliveries) and torch.equal(a.clashes, b.clashes)
    assert not torch.equal(a.state.agent_xy, c.state.agent_xy)
