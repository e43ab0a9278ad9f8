"""The port's full-field replan (bfs_backend="xla") against the JAX package.

`dynamic_fields` (the plain version of K3 on the CPU) equals the JAX XLA
relaxation and the Pallas kernel `bfs_dist_pallas` in interpret mode, bit
for bit; `dist_nextdir_at` equals the JAX read-out; the port's step on the
full-field branch equals the JAX step (whose CPU default is that branch)
over whole states; and the full-field and compacted branches give identical
rollouts when compaction is off (replan_row_frac = 1.0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.env import pathfinding as jpf
from swarm_ode_tpu.env.state import agent_class as jagent_class
from swarm_ode_tpu.env.state import occupancy_grids as jocc
from swarm_ode_tpu.ops.bfs_pallas import bfs_dist_pallas
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.env import pathfinding as ppf
from swarm_ode_tpu_torch.env import step as pstep
from swarm_ode_tpu_torch.env.state import agent_class
from swarm_ode_tpu_torch.ops import bfs_pallas
from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout
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


def _field_inputs(jp, B, seed):
    """Occupancy, random rack targets and own cells of B JAX reset states."""
    js = jax_reset_batch(jp, B, seed=seed)
    occ = jax.vmap(lambda s: (lambda g: (g[0] > 0) | (g[1] > 0))(jocc(jp, s)))(js)
    rng = np.random.RandomState(seed)
    tgt_idx = rng.randint(jp.num_goals, jp.num_actions - 1, size=(B, jp.num_agents))
    tgt = np.asarray(jp.action_cells)[tgt_idx].astype(np.int32)
    self_yx = np.asarray(js.agent_xy)[..., ::-1].astype(np.int32)
    # A few agents stand on their own target (distance 0, no move).
    self_yx[:, 0] = tgt[:, 0]
    return np.asarray(occ), tgt, np.ascontiguousarray(self_yx)


@pytest.mark.parametrize("env_id", [TINY, MEDIUM])
def test_dynamic_fields_and_readout_match_jax(env_id):
    jp, _, pp, _ = both(env_id, bfs_backend="xla")
    occ, tgt, self_yx = _field_inputs(jp, 3, seed=4)
    cls = jagent_class(jp)

    def one(o, t, s):
        dist, pas = jpf.dynamic_fields(jp, o, t, s, cls)
        d, nd = jpf.dist_nextdir_at(jp, dist, pas, s)
        return dist, pas, d, nd

    jdist, jpas, jd, jnd = jax.vmap(one)(jnp.asarray(occ), jnp.asarray(tgt), jnp.asarray(self_yx))
    def t(a):
        return torch.from_numpy(np.array(a))

    dist, pas = ppf.dynamic_fields(pp, t(occ), t(tgt), t(self_yx), agent_class(pp))
    d, nd = ppf.dist_nextdir_at(pp, dist, pas, t(self_yx))
    assert_same(
        {"dist": np.asarray(jdist), "pas": np.asarray(jpas), "d": np.asarray(jd),
         "nd": np.asarray(jnd)},
        {"dist": dist.numpy(), "pas": pas.numpy(), "d": d.numpy(), "nd": nd.numpy()},
        env_id,
    )
    assert (d == 0).any() and (d > 0).any() and (d < bfs_pallas.INF).all()


def test_bfs_dist_plain_matches_pallas_interpret():
    """Random grids (ties everywhere), targets on every edge and corner, one
    target on an occupied cell (it still starts at 0), few and many sweeps."""
    rng = np.random.RandomState(7)
    K, H, W = 12, 9, 8
    pas = rng.rand(K, H, W) < 0.7
    ty, tx = rng.randint(0, H, K), rng.randint(0, W, K)
    ty[0], tx[1], ty[2], tx[3] = 0, 0, H - 1, W - 1
    ty[4], tx[4] = H - 1, 0
    pas[np.arange(K), ty, tx] = True
    pas[5, ty[5], tx[5]] = False
    tgt = (ty * W + tx).astype(np.int32)
    for iters in (3, 40):
        ref = bfs_dist_pallas(jnp.asarray(pas), jnp.asarray(tgt), iters, interpret=True)
        got = bfs_pallas.bfs_dist_call(torch.from_numpy(pas), torch.from_numpy(tgt), iters)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dynamic_fields_matches_pallas_interpret():
    """The medium env's own rows through K3's TPU form (interpret mode),
    as tests/test_pallas_kernels.py runs it at tiny size."""
    jp, _, pp, _ = both(MEDIUM, bfs_backend="xla")
    occ, tgt, self_yx = _field_inputs(jp, 1, seed=9)
    dist, pas = ppf.dynamic_fields(pp, *(torch.from_numpy(np.array(a)) for a in (occ, tgt, self_yx)),
                                   agent_class(pp))
    tgt_flat = jnp.asarray(tgt[0, :, 0] * jp.grid_w + tgt[0, :, 1])
    ref = bfs_dist_pallas(jnp.asarray(pas[0].numpy()), tgt_flat, jp.dynamic_bfs_iters,
                          interpret=True)
    np.testing.assert_array_equal(dist[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("env_id,B", [(TINY, 8), (MEDIUM, 3)], ids=["tiny", "medium"])
def test_full_field_step_matches_jax(env_id, B):
    """30 steps of the JAX step (CPU default: the full-field XLA branch)
    and the port's step with bfs_backend="xla", the JAX draws injected."""
    jp, jl, pp, _ = both(env_id, bfs_backend="xla")
    assert jp.bfs_backend == pp.bfs_backend == "xla"
    js = jax_reset_batch(jp, B, seed=21)
    jh = jax_heuristic_init(jp, B)
    policy, jstep = jax_policy_fn(jp, jl), jax_step_fn(jp)
    ps = convert.env_state_from_numpy(fields(js), device="cpu")
    clashes = 0
    for t in range(30):
        actions, jh = policy(js, jh)
        noise, _ = jax_noise(jp, js.key)
        js, jr, jdone, jinfo = jstep(js, actions)
        ps, pr, pdone, pinfo = pstep.step(pp, ps, torch.from_numpy(np.array(actions)), noise=noise)
        assert_same(fields(js), convert.env_state_to_numpy(ps), f"step {t} state")
        assert_same({"rewards": np.asarray(jr), "done": np.asarray(jdone)},
                    {"rewards": pr.numpy(), "done": pdone.numpy()}, f"step {t}")
        assert_same(numpy_dict(jinfo), torch_dict(pinfo), f"step {t} info")
        clashes += int(pinfo["clashes"].sum())
    # A clash is decided from the dynamic field at the agent's own cell.
    assert clashes > 0, "no clash: the full-field read-out was not exercised"


def test_full_field_equals_compacted_without_compaction():
    """With replan_row_frac = 1.0 every row runs in both branches, so the
    full field read at the own cell and the compacted query agree on every
    state, whatever the `need` rule flags."""
    _, _, full, lay = both(MEDIUM, bfs_backend="xla", replan_row_frac=1.0)
    _, _, comp, _ = both(MEDIUM, bfs_backend="auto", replan_row_frac=1.0)
    B, T = 6, 60
    g = torch.Generator().manual_seed(3)
    start = pstep.reset(full, B, g)
    noise = [pstep.draw_noise(full, B, g) for _ in range(T)]
    a = heuristic_rollout(full, lay, B, T, state=start, noise=noise, record=True)
    b = heuristic_rollout(comp, lay, B, T, state=start, noise=noise, record=True)
    for t, (sa, sb) in enumerate(zip(a.trace, b.trace)):
        assert_same(convert.env_state_to_numpy(sa[3]), convert.env_state_to_numpy(sb[3]),
                    f"step {t}")
        assert torch.equal(sa[0], sb[0]), f"step {t} actions"
    assert int(a.replan_overflow.sum()) == 0 and int(b.replan_overflow.sum()) == 0
    assert int(a.deliveries.sum()) > 0
