"""The port's replan BFS against the JAX package's Pallas kernels (interpret
mode): each plain query against its own JAX kernel, `query_plain` against K2
(`_pallas_query_call`, rows padded to HWp) and `bitpack_query_plain` against
K1 (`bitpack_query_call`, rows padded to 32*words), for every int32 target;
the compacted batched query with its overflow count against
`bfs_query_occ_batched`. All bit-exact."""
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
from swarm_ode_tpu.ops.bfs_pallas import _passable_rows as jax_passable_rows
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


JAX_QUERIES = {"int32": _jax_int32_query, "bitpack32": _jax_bitpack_query}
PLAINS = {"int32": bfs_pallas.query_plain, "bitpack32": bfs_bitpack.bitpack_query_plain}


def _row_length(kernel, H, W):
    """L, the padded row each query's neighbours wrap in."""
    if kernel == "int32":
        return bfs_pallas.query_length(H, W)
    return 32 * bfs_bitpack._plan(H, W)[2]


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


def _plains(pas, tgt, pos, H, W, iters):
    """{kernel: (d, nd)} of both plain queries, as numpy."""
    args = (torch.from_numpy(pas), torch.from_numpy(tgt), torch.from_numpy(pos), H, W, iters)
    out = {}
    for kernel, plain in PLAINS.items():
        d, nd = plain(*args)
        assert d.dtype == torch.int32 and nd.dtype == torch.int32
        out[kernel] = d.numpy(), nd.numpy()
    return out


def _check_against_own_kernels(pas, tgt, pos, H, W, iters):
    """Each plain query equals its own JAX kernel; on these in-grid targets
    the two also equal each other."""
    got = _plains(pas, tgt, pos, H, W, iters)
    for kernel, ref in JAX_QUERIES.items():
        d_ref, nd_ref = ref(pas, tgt, pos, H, W, iters)
        np.testing.assert_array_equal(got[kernel][0], d_ref, err_msg=kernel)
        np.testing.assert_array_equal(got[kernel][1], nd_ref, err_msg=kernel)
    for a, b in zip(got["int32"], got["bitpack32"]):
        np.testing.assert_array_equal(a, b)
    return got["int32"]


@pytest.mark.parametrize("H,W,iters,density", [
    (9, 8, 20, 0.75),  # many ties, some unreachable rows
    (6, 5, 3, 0.9),  # iters below the distances: INF by sweep budget
    (12, 30, 30, 0.75),  # Ws = 31: the widest walled row K1 takes
])
def test_plain_query_matches_pallas_kernels_random(H, W, iters, density):
    pas, tgt, pos = _random_rows(H, W, 24, seed=H * W, density=density)
    d, nd = _check_against_own_kernels(pas, tgt, pos, H, W, iters)
    # The rows cover reached and unreached cells and several next hops.
    assert (d < bfs_pallas.INF).any() and (d >= bfs_pallas.INF).any()
    assert len(set(nd.tolist())) >= 3


@pytest.mark.parametrize("kernel", ["int32", "bitpack32"])
@pytest.mark.parametrize("H,W", [(9, 8), (25, 22)])
def test_margin_row_query_matches_jax(H, W, kernel):
    """Walled targets in the margin row below the grid, [n, n + W+1),
    which the JAX kernels seed and which reach the grid's last row. Each
    plain query is pinned to its own JAX kernel on the whole row: the
    bit-packed one wraps modulo its 32*words bits, so where a target's lower
    neighbour t + W+1 lies past them, it reaches row 0 across the wrap."""
    Ws = W + 1
    n = H * Ws
    pas, _, pos = _random_rows(H, W, 4 * Ws, seed=n)
    tgt = (n + np.arange(4 * Ws) % Ws).astype(np.int32)
    iters = 40
    d, nd = _plains(pas, tgt, pos, H, W, iters)[kernel]
    d_ref, nd_ref = JAX_QUERIES[kernel](pas, tgt, pos, H, W, iters)
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_array_equal(nd, nd_ref)
    assert (d < bfs_pallas.INF).mean() > 0.5  # the margin seeds reach the grid


@pytest.mark.parametrize("iters", [0, 1, 8, 40])
@pytest.mark.parametrize("H,W", [(9, 8), (25, 22), (12, 30)])
def test_query_plains_match_jax_on_every_target(H, W, iters):
    """Every walled target in [-3(W+1), L + 3(W+1)) of each query's own
    padded row L, and -1, INT32_MIN, INT32_MAX, one random row each (own
    cells in the grid, targets not freed, so some in-grid targets are
    impassable): each plain query equals its own JAX kernel bit for bit. On
    targets in the grid, impassable ones included, the two queries agree."""
    Ws = W + 1
    n = H * Ws
    rng = np.random.RandomState(H * W + iters)
    got = {}
    for kernel, ref in JAX_QUERIES.items():
        L = _row_length(kernel, H, W)
        tgt = np.concatenate([np.arange(-3 * Ws, L + 3 * Ws), [-1, -2**31, 2**31 - 1]])
        tgt = tgt.astype(np.int32)
        K = tgt.size
        grid = rng.rand(K, H, W) < 0.8
        pas = np.pad(grid, [(0, 0), (0, 0), (0, 1)]).reshape(K, n)
        pos = (rng.randint(0, H, K) * Ws + rng.randint(0, W, K)).astype(np.int32)
        d_ref, nd_ref = ref(pas, tgt, pos, H, W, iters)
        got = _plains(pas, tgt, pos, H, W, iters)
        np.testing.assert_array_equal(got[kernel][0], d_ref, err_msg=kernel)
        np.testing.assert_array_equal(got[kernel][1], nd_ref, err_msg=kernel)
        inside = (tgt >= 0) & (tgt < n)
        for a, b in zip(got["int32"], got["bitpack32"]):
            np.testing.assert_array_equal(a[inside], b[inside])
        assert not pas[inside, tgt[inside]].all()  # impassable targets in the grid
        if iters >= 8:  # targets outside the grid reach it across the margin and the wrap
            assert (d_ref[~inside] < bfs_pallas.INF).any()


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
    _check_against_own_kernels(
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
        base_w=bfs_pallas.class_base_rows(torch.from_numpy(np.array(jp.picker_passable))),
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
            t["occ_w"], t["tgt_w"], t["pos_w"], t["classes"], t["need"], x["base_w"],
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
    tgt = torch.zeros(2, A, dtype=torch.int32)
    need = torch.zeros(2, A, dtype=torch.bool)
    chosen, *rows = bfs_pallas.compact_rows(
        tgt, tgt, torch.zeros(A, dtype=torch.int32), need, row_frac=0.22, rows_per_block=8,
    )
    assert chosen.shape == (16,)
    assert all(r.shape == (16,) and r.dtype == torch.int32 for r in rows)


@pytest.mark.parametrize("frac", [1.0, 0.3])
def test_compact_rows_give_jax_passable_rows(frac):
    """compact_rows returns each chosen row's env, class, target and own
    cell, and builds no mask; the plain row build from them
    (`_passable_rows`) equals the JAX package's `_passable_rows` on the rows
    its compaction takes."""
    x = _occ_inputs(TINY, B=5, seed=7)
    B, A = x["tgt_w"].shape
    t = {k: torch.from_numpy(np.array(x[k])) for k in ("tgt_w", "pos_w", "classes", "need")}
    chosen, envK, classK, tgtK, posK = bfs_pallas.compact_rows(
        t["tgt_w"], t["pos_w"], t["classes"], t["need"], row_frac=frac, rows_per_block=8)
    idx = np.arange(B * A) if chosen is None else chosen.numpy()
    assert (chosen is None) == (frac == 1.0)
    np.testing.assert_array_equal(envK.numpy(), idx // A)
    np.testing.assert_array_equal(classK.numpy(), x["classes"][idx % A])
    np.testing.assert_array_equal(tgtK.numpy(), x["tgt_w"].reshape(-1)[idx])
    np.testing.assert_array_equal(posK.numpy(), x["pos_w"].reshape(-1)[idx])
    got = bfs_pallas._passable_rows(torch.from_numpy(x["occ_w"]), envK, classK, x["base_w"],
                                    tgtK, posK)
    ref = jax_passable_rows(jnp.asarray(x["occ_w"][idx // A]), jnp.asarray(classK.numpy()),
                            jnp.asarray(tgtK.numpy()), jnp.asarray(posK.numpy()),
                            jnp.asarray(x["pick_w"]), x["H"], x["W"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref) != 0)


def test_passable_rows_of_an_env_outside_the_batch_are_occupied():
    """An env index outside [0, B) reads as an env whose every cell is
    occupied: only the target and own cell stay free (the kernel reads no
    occupancy row for it)."""
    H, W = 4, 5
    occ = bfs_pallas.walled_rows(torch.zeros(2, H, W, dtype=torch.bool))
    base = bfs_pallas.class_base_rows(torch.ones(H, W, dtype=torch.bool))
    env = torch.tensor([0, 1, 2, -1, -3], dtype=torch.int32)
    cell = torch.tensor([0, 7, 9, 13, 20], dtype=torch.int32)
    rows = bfs_pallas._passable_rows(occ, env, torch.zeros(5, dtype=torch.int32), base, cell, cell)
    assert rows[:2].equal(base[[0, 0]])
    assert rows[2:].sum(1).tolist() == [1, 1, 1]
    assert rows[torch.arange(5), cell.long()].all()


def test_plan_rejects_wide_walled_rows():
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack._plan(3, 31)  # Ws = 32
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack._plan(3, 33)
    assert bfs_bitpack._plan(45, 30)[2] == 45  # extralarge: 45 words
    assert bfs_bitpack._plan(25, 22)[2] == 19  # medium: 19 words
    one = torch.zeros(1, dtype=torch.int32)
    occ = bfs_pallas.walled_rows(torch.zeros(1, 3, 31, dtype=torch.bool))
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack.bitpack_query_call(occ, one, one, torch.cat([occ, occ]), one, one, 3, 31, 4)


def _random_envs(H, W, B, K, seed):
    """Occupancy-form query inputs: B random envs, K rows over them (own
    cells on every edge and corner), class base rows of a random highway."""
    g = torch.Generator().manual_seed(seed)
    Ws = W + 1
    occ = bfs_pallas.walled_rows(torch.rand(B, H, W, generator=g) < 0.1)
    base = bfs_pallas.class_base_rows(torch.rand(H, W, generator=g) < 0.85)
    env = torch.randint(0, B, (K,), generator=g).int()
    cls = torch.randint(0, 2, (K,), generator=g).int()
    py, px = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    py[0::4], px[1::4], py[2::4], px[3::4] = 0, 0, H - 1, W - 1
    tgt = (torch.randint(0, H, (K,), generator=g) * Ws + torch.randint(0, W, (K,), generator=g))
    return occ, env, cls, base, tgt.int(), (py * Ws + px).int()


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors each wrapper returns its plain version on the rows
    `_passable_rows` builds and launches nothing; the kernel-argument guard
    refuses what the kernel cannot take."""
    H, W = 9, 8
    args = _random_envs(H, W, 4, 16, seed=4)
    occ, env, cls, base, tgt, pos = args
    pas = bfs_pallas._passable_rows(*args)
    before = (bfs_bitpack.LAUNCHES, bfs_pallas.LAUNCHES)
    for call, plain in ((bfs_bitpack.bitpack_query_call, bfs_bitpack.bitpack_query_plain),
                        (bfs_pallas.query_call, bfs_pallas.query_plain)):
        ref = plain(pas, tgt, pos, H, W, 12)
        got = call(*args, H, W, 12)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    assert (bfs_bitpack.LAUNCHES, bfs_pallas.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        bfs_pallas.check_query_args(*args, H, W)
    with pytest.raises(ValueError, match="bool"):
        bfs_pallas.check_query_args(occ.int(), *args[1:], H, W)
    with pytest.raises(ValueError, match="16-byte"):
        bfs_pallas.check_query_args(occ.contiguous(), *args[1:], H, W)
    with pytest.raises(ValueError, match="int32"):
        bfs_pallas.check_query_args(occ, env.long(), *args[2:], H, W)
    with pytest.raises(ValueError, match="cells"):
        bfs_pallas.query_plain(pas[:, :-1], tgt, pos, H, W, 12)
