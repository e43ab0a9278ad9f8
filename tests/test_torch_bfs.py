"""The port's replan BFS against the JAX package's Pallas kernels (interpret
mode): the plain query against K1 (`bitpack_query_call`) and K2
(`_pallas_query_call`), and the compacted batched query with its overflow
count against `bfs_query_occ_batched`. All bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.env.pathfinding import passable_walled
from swarm_ode_tpu.env.state import agent_class as jax_agent_class
from swarm_ode_tpu.env.state import occupancy_grids as jax_occupancy_grids
from swarm_ode_tpu.ops.bfs_bitpack import bitpack_query_call as jax_bitpack_query_call
from swarm_ode_tpu.ops.bfs_pallas import _pallas_query_call, _round_up
from swarm_ode_tpu.ops.bfs_pallas import bfs_query_occ_batched as jax_occ_batched
from swarm_ode_tpu_torch.env.pathfinding import QUERIES
from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas
from torch_port_helpers import MEDIUM, TINY, both, jax_reset_batch


def _jax_int32_query(pas, tgt, pos, H, W, iters):
    """K2 in interpret mode on (K, n) rows (padded as the JAX callers do)."""
    K, n = pas.shape
    Ws = W + 1
    HWp = _round_up(n + Ws, 128)
    Kp = _round_up(K, 8)
    pasP = jnp.pad(jnp.asarray(pas, jnp.int32), ((0, Kp - K), (0, HWp - n)))
    t = jnp.pad(jnp.asarray(tgt, jnp.int32), (0, Kp - K)).reshape(Kp, 1)
    p = jnp.pad(jnp.asarray(pos, jnp.int32), (0, Kp - K)).reshape(Kp, 1)
    d, nd = _pallas_query_call(pasP, t, p, Ws, iters, 8, True)
    return np.asarray(d[:K, 0]), np.asarray(nd[:K, 0])


def _jax_bitpack_query(pas, tgt, pos, H, W, iters):
    d, nd = jax_bitpack_query_call(
        jnp.asarray(pas, jnp.int32), jnp.asarray(tgt), jnp.asarray(pos), H, W, iters,
        rows_per_block=8, interpret=True,
    )
    return np.asarray(d[:, 0]), np.asarray(nd[:, 0])


def _random_rows(H, W, K, seed, density=0.75):
    """Random walled grids with the target and own cell forced free (as the
    env does), plus rows whose own cell sits on every edge and corner."""
    Ws = W + 1
    n = H * Ws
    rng = np.random.RandomState(seed)
    grid = rng.rand(K, H, W) < density
    pas = np.pad(grid, [(0, 0), (0, 0), (0, 1)]).reshape(K, n)
    ty, tx = rng.randint(0, H, K), rng.randint(0, W, K)
    py, px = rng.randint(0, H, K), rng.randint(0, W, K)
    edges = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1), (0, W // 2), (H // 2, 0),
             (H - 1, W // 2), (H // 2, W - 1)]
    for i, (y, x) in enumerate(edges[: K // 2]):
        py[i], px[i] = y, x
    tgt = (ty * Ws + tx).astype(np.int32)
    pos = (py * Ws + px).astype(np.int32)
    col = np.arange(n)[None, :]
    pas = pas | (col == tgt[:, None]) | (col == pos[:, None])
    return pas, tgt, pos


def _plain(pas, tgt, pos, H, W, iters):
    d, nd = bfs_pallas.query_plain(
        torch.from_numpy(pas), torch.from_numpy(tgt), torch.from_numpy(pos), H, W, iters
    )
    assert d.dtype == torch.int32 and nd.dtype == torch.int32
    return d.numpy(), nd.numpy()


def _check_against_both_kernels(pas, tgt, pos, H, W, iters):
    d, nd = _plain(pas, tgt, pos, H, W, iters)
    for ref in (_jax_int32_query, _jax_bitpack_query):
        d_ref, nd_ref = ref(pas, tgt, pos, H, W, iters)
        np.testing.assert_array_equal(d, d_ref)
        np.testing.assert_array_equal(nd, nd_ref)
    return d, nd


@pytest.mark.parametrize("H,W,iters,density", [
    (9, 8, 20, 0.75),  # many ties, some unreachable rows
    (6, 5, 3, 0.9),  # iters below the distances: INF by sweep budget
    (12, 30, 30, 0.75),  # Ws = 31: the widest walled row K1 takes
])
def test_plain_query_matches_pallas_kernels_random(H, W, iters, density):
    pas, tgt, pos = _random_rows(H, W, 24, seed=H * W, density=density)
    d, nd = _check_against_both_kernels(pas, tgt, pos, H, W, iters)
    # The rows cover reached and unreached cells and several next hops.
    assert (d < bfs_pallas.INF).any() and (d >= bfs_pallas.INF).any()
    assert len(set(nd.tolist())) >= 3


@pytest.mark.parametrize("env_id", [TINY, MEDIUM])
def test_plain_query_matches_pallas_kernels_env_masks(env_id):
    """Real passable masks: reset occupancy, random rack targets."""
    jp, _, _, _ = both(env_id)
    H, W = jp.grid_h, jp.grid_w
    Ws = W + 1
    cls = jax_agent_class(jp)
    A = jp.num_agents
    rng = np.random.RandomState(1)
    B = 2
    states = jax_reset_batch(jp, B, seed=3)
    pases, tgts, poss = [], [], []
    for b in range(B):
        es = jax.tree.map(lambda a: a[b], states)
        agv_g, pick_g, _, _ = jax_occupancy_grids(jp, es)
        occ = (agv_g > 0) | (pick_g > 0)
        tgt = jp.action_cells[jnp.asarray(rng.randint(jp.num_goals, jp.num_actions - 1, A))]
        self_yx = es.agent_xy[:, ::-1]
        pases.append(np.asarray(passable_walled(jp, occ, tgt, self_yx, cls)))
        tgts.append(np.asarray(tgt[:, 0] * Ws + tgt[:, 1], np.int32))
        poss.append(np.asarray(self_yx[:, 0] * Ws + self_yx[:, 1], np.int32))
    _check_against_both_kernels(
        np.concatenate(pases), np.concatenate(tgts), np.concatenate(poss), H, W,
        int(jp.dynamic_bfs_iters),
    )


def _occ_inputs(env_id, B, seed):
    """Batched inputs of bfs_query_occ_batched from real reset states."""
    jp, _, pp, _ = both(env_id)
    H, W = jp.grid_h, jp.grid_w
    Ws = W + 1
    n = H * Ws
    A = jp.num_agents
    rng = np.random.RandomState(seed)
    states = jax_reset_batch(jp, B, seed=seed)
    occs, tgts, poss = [], [], []
    for b in range(B):
        es = jax.tree.map(lambda a: a[b], states)
        agv_g, pick_g, _, _ = jax_occupancy_grids(jp, es)
        occ = (agv_g > 0) | (pick_g > 0)
        tgt = np.asarray(jp.action_cells)[rng.randint(jp.num_goals, jp.num_actions - 1, A)]
        self_yx = np.asarray(es.agent_xy)[:, ::-1]
        occs.append(np.pad(np.asarray(occ), ((0, 0), (0, 1))).reshape(n))
        tgts.append(tgt[:, 0] * Ws + tgt[:, 1])
        poss.append(self_yx[:, 0] * Ws + self_yx[:, 1])
    pick_w = np.pad(np.asarray(jp.picker_passable), ((0, 0), (0, 1))).reshape(n)
    need = rng.rand(B, A) < 0.4
    return dict(
        occ_w=np.stack(occs), tgt_w=np.stack(tgts).astype(np.int32),
        pos_w=np.stack(poss).astype(np.int32), classes=np.asarray(jax_agent_class(jp)),
        need=need, pick_w=pick_w, H=H, W=W, iters=int(jp.dynamic_bfs_iters),
    )


@pytest.mark.parametrize("kernel", ["int32", "bitpack32"])
def test_compacted_query_matches_jax(kernel):
    """Row choice, scatter-back and per-env overflow equal the JAX
    compaction, uncompacted, compacted, and over budget."""
    x = _occ_inputs(TINY, B=5, seed=2)
    n_need = int(x["need"].sum())
    arrays = ("occ_w", "tgt_w", "pos_w", "classes", "need", "pick_w")
    for frac in (1.0, 0.5, 0.1):
        ref = jax_occ_batched(
            *(jnp.asarray(x[k]) for k in ("occ_w", "tgt_w", "pos_w", "classes", "need", "pick_w")),
            x["H"], x["W"], x["iters"], row_frac=frac, rows_per_block=8, interpret=True,
            kernel=kernel,
        )
        t = {k: torch.from_numpy(np.array(x[k])) for k in arrays}
        got = bfs_pallas.bfs_query_occ_batched(
            t["occ_w"], t["tgt_w"], t["pos_w"], t["classes"], t["need"], t["pick_w"],
            x["H"], x["W"], x["iters"], row_frac=frac, rows_per_block=8,
            query=QUERIES[kernel],
        )
        for name, a, b in zip(("d", "nd", "overflow"), ref, got):
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{name} frac={frac}")
        if frac == 0.1:  # K = 8 rows for n_need flagged rows
            assert int(got[2].sum()) == n_need - 8 > 0


def test_compaction_budget_matches_jax_expression():
    """K = round_up(int(B*A*row_frac), rows_per_block): at the main path
    (medium, B = 2048, row_frac 0.22, blocks of 128) that is 12,672 rows."""
    _, _, pp, _ = both(MEDIUM)
    B, A = 2048, pp.num_agents
    K = bfs_pallas._round_up(max(int(B * A * pp.replan_row_frac), 1), 128)
    assert K == 12672
    occ = torch.zeros(2, pp.grid_h * (pp.grid_w + 1), dtype=torch.bool)
    tgt = torch.zeros(2, A, dtype=torch.int32)
    need = torch.zeros(2, A, dtype=torch.bool)
    chosen, pasK, tgtK, posK = bfs_pallas.compact_rows(
        occ, tgt, tgt, torch.zeros(A, dtype=torch.int32), need, occ[0], pp.grid_h,
        pp.grid_w, row_frac=0.22, rows_per_block=8,
    )
    assert chosen.shape == (16,) and pasK.shape == (16, occ.shape[1])


def test_plan_rejects_wide_walled_rows():
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack._plan(3, 31)  # Ws = 32
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack._plan(3, 33)
    assert bfs_bitpack._plan(45, 30)[2] == 45  # extralarge: 45 words
    assert bfs_bitpack._plan(25, 22)[2] == 19  # medium: 19 words
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack.bitpack_query_call(
            torch.zeros(1, 3 * 32, dtype=torch.bool), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), 3, 31, 4,
        )


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors both wrappers return the plain result and launch
    nothing; the kernel-argument guard refuses what a kernel cannot take."""
    H, W = 9, 8
    pas, tgt, pos = _random_rows(H, W, 16, seed=4)
    args = (torch.from_numpy(pas), torch.from_numpy(tgt), torch.from_numpy(pos), H, W, 12)
    before = (bfs_bitpack.LAUNCHES, bfs_pallas.LAUNCHES)
    ref = bfs_pallas.query_plain(*args)
    for call in (bfs_bitpack.bitpack_query_call, bfs_pallas.query_call):
        got = call(*args)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert (bfs_bitpack.LAUNCHES, bfs_pallas.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        bfs_pallas.check_query_args(*args[:5])
    with pytest.raises(TypeError):
        bfs_pallas.check_query_args(args[0].int(), *args[1:5])
    with pytest.raises(ValueError, match="int32"):
        bfs_pallas.check_query_args(args[0], args[1].long(), *args[2:5])
    with pytest.raises(ValueError, match="cells"):
        bfs_pallas.query_plain(args[0][:, :-1], *args[1:])
