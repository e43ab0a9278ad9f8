"""The port's env step against the JAX package's, bit for bit.

Each case starts both from the same JAX-made reset states, drives them with
the JAX dispatcher's actions, injects the JAX step's own random draws into
the port, and compares the whole EnvState (the PRNG key aside), the rewards,
`done` and every info field after every step. At these batch sizes the
compaction budget covers every row (B*A <= 128), so the JAX CPU path (the
uncompacted XLA relaxation) is the exact reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.env import step as pstep
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

CASES = [
    # (env id, overrides, B, steps)
    (TINY, {}, 4, 40),
    (TINY, dict(replan_rejoin=False, deadlock_break=3), 4, 40),
    ("tarware-tiny-4agvs-0pickers-globalobs-v1", dict(reward_type=0), 3, 40),
    (MEDIUM, {}, 3, 40),
    (MEDIUM, dict(replan_rejoin=False, deadlock_break=3), 3, 30),
    (MEDIUM, dict(replan_mode="greedy"), 2, 30),
    (MEDIUM, dict(replan_mode="off", deadlock_break=3), 2, 30),
]


def _case_id(case):
    env_id, ov, B, T = case
    size = env_id.split("-")[1] + ("-0pickers" if "0pickers" in env_id else "")
    return "-".join([size] + [f"{k}={v}" for k, v in ov.items()])


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_step_matches_jax(case):
    env_id, overrides, B, T = case
    jp, jl, pp, _ = both(env_id, **overrides)
    js = jax_reset_batch(jp, B, seed=11)
    if jp.deadlock_break:
        # Start some agents mid-escape so that Phase 1c runs from step 0.
        brk = np.random.RandomState(0).randint(0, 4, np.asarray(js.agent_break).shape)
        js = js.replace(agent_break=jnp.asarray(brk, jnp.int32))
    jh = jax_heuristic_init(jp, B)
    policy, jstep = jax_policy_fn(jp, jl), jax_step_fn(jp)
    ps = convert.env_state_from_numpy(fields(js), device="cpu")
    events = dict(deliveries=0, clashes=0, replans=0, escapes=0)
    for t in range(T):
        actions, jh = policy(js, jh)
        noise, _ = jax_noise(jp, js.key)
        js, jr, jdone, jinfo = jstep(js, actions)
        ps, pr, pdone, pinfo = pstep.step(
            pp, ps, torch.from_numpy(np.array(actions)), noise=noise
        )
        assert_same(fields(js), convert.env_state_to_numpy(ps), f"step {t} state")
        assert_same(
            {"rewards": np.asarray(jr), "done": np.asarray(jdone)},
            {"rewards": pr.numpy(), "done": pdone.numpy()},
            f"step {t}",
        )
        assert_same(numpy_dict(jinfo), torch_dict(pinfo), f"step {t} info")
        events["deliveries"] += int(pinfo["shelf_deliveries"].sum())
        events["clashes"] += int(pinfo["clashes"].sum())
        events["replans"] += int(ps.agent_replan.sum())
        events["escapes"] += int((ps.agent_break > 0).sum())
    # The run exercised the phases it is meant to cover.
    assert events["clashes"] > 0 and events["deliveries"] + events["replans"] > 0, events
    if jp.deadlock_break:
        assert events["escapes"] > 0, events


def test_reset_draws_valid_states():
    _, _, pp, _ = both(MEDIUM)
    g = torch.Generator().manual_seed(0)
    s = pstep.reset(pp, 16, g)
    hw = {tuple(c) for c in pp.highway_cells.tolist()}
    for b in range(16):
        cells = [tuple(c) for c in s.agent_xy[b].flip(-1).tolist()]
        assert len(set(cells)) == pp.num_agents and set(cells) <= hw
        q = s.request_queue[b].tolist()
        assert len(set(q)) == pp.request_queue_size and 1 <= min(q) and max(q) <= pp.num_shelves
    assert s.agent_dir.dtype == torch.int32 and 0 <= int(s.agent_dir.min()) and int(s.agent_dir.max()) <= 3
    assert torch.equal(s.stuck_xy, s.agent_xy)
    again = pstep.reset(pp, 16, torch.Generator().manual_seed(0))
    assert torch.equal(again.agent_xy, s.agent_xy) and torch.equal(again.request_queue, s.request_queue)


def test_draw_noise_shapes():
    _, _, pp, _ = both(TINY, deadlock_break=2)
    n = pstep.draw_noise(pp, 5, torch.Generator().manual_seed(1))
    assert n.break_r.shape == (5, pp.num_agents) and n.break_r.dtype == torch.int32
    assert int(n.break_r.min()) >= 0 and int(n.break_r.max()) <= 3
    g = n.delivery_gumbel
    assert g.shape == (5, pp.num_goals, pp.num_shelves) and g.dtype == torch.float32
    assert torch.isfinite(g).all()


def test_step_needs_a_source_of_draws():
    _, _, pp, _ = both(TINY)
    s = pstep.reset(pp, 2, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        pstep.step(pp, s, torch.zeros(2, pp.num_agents, dtype=torch.int32))
