"""The CUDA kernels against their plain PyTorch version, on the card.

Needs an NVIDIA GPU; skips without one. It imports neither jax nor the JAX
package, so it also runs where only the port's dependencies are installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas, segment_pallas


def _random_envs(H, W, B, K, seed):
    """Occupancy-form query inputs on the CPU: B random envs, K rows over
    them (own cells on every edge and corner), class base rows of a random
    highway."""
    g = torch.Generator().manual_seed(seed)
    Ws = W + 1
    occ = bfs_pallas.walled_rows(torch.rand(B, H, W, generator=g) < 0.1)
    base = bfs_pallas.class_base_rows(torch.rand(H, W, generator=g) < 0.85)
    env = torch.randint(0, B, (K,), generator=g).int()
    cls = torch.randint(0, 2, (K,), generator=g).int()
    py, px = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    py[0::4], px[1::4], py[2::4], px[3::4] = 0, 0, H - 1, W - 1
    tgt = torch.randint(0, H, (K,), generator=g) * Ws + torch.randint(0, W, (K,), generator=g)
    return occ, env, cls, base, tgt.int(), (py * Ws + px).int()


def _to(args, device):
    """Query inputs on `device`, the rows kept 16-byte aligned there."""
    occ, env, cls, base, tgt, pos = args
    rows = []
    for r in (occ, base):
        buf = torch.zeros(r.shape[0], r.stride(0), dtype=torch.bool, device=device)
        buf[:, :r.shape[1]] = r
        rows.append(buf[:, :r.shape[1]])
    return rows[0], env.to(device), cls.to(device), rows[1], tgt.to(device), pos.to(device)


# Each query wrapper with its plain version and its launch counter.
QUERIES = {
    "K1": (bfs_bitpack.bitpack_query_call, bfs_bitpack.bitpack_query_plain, bfs_bitpack),
    "K2": (bfs_pallas.query_call, bfs_pallas.query_plain, bfs_pallas),
}


def _check_query(kernel, args, H, W, iters, device):
    """One launch of `kernel` on the card against `_passable_rows` + its
    plain version on the CPU; returns the card's (d, nd) on the CPU."""
    call, plain, counter = QUERIES[kernel]
    ref = plain(bfs_pallas._passable_rows(*args), args[4], args[5], H, W, iters)
    before = counter.LAUNCHES
    d, nd = call(*_to(args, device), H, W, iters)
    torch.cuda.synchronize()
    assert counter.LAUNCHES == before + 1
    assert torch.equal(d.cpu(), ref[0]) and torch.equal(nd.cpu(), ref[1]), kernel
    return d.cpu(), nd.cpu()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # Full f32 matrix products: the comparisons below hold kernels to their
    # plain versions, not to TF32 rounding.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(25, 22), (45, 30), (80, 30)])  # 18, 44 and 77 words
def test_kernels_match_plain(cuda, H, W):
    """K1 and K2, building their rows from the envs' occupancy, against
    `_passable_rows` + each one's plain version, bit for bit; on these
    in-grid targets the two agree."""
    args = _random_envs(H, W, 64, 512, seed=H + W)
    d1, nd1 = _check_query("K1", args, H, W, 40, cuda)
    d2, nd2 = _check_query("K2", args, H, W, 40, cuda)
    assert torch.equal(d1, d2) and torch.equal(nd1, nd2)
    assert (d1 < bfs_pallas.INF).any() and (d1 >= bfs_pallas.INF).any()


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take(cuda):
    occ, env, cls, base, tgt, pos = _to(_random_envs(9, 8, 4, 16, seed=0), cuda)
    with pytest.raises(ValueError, match="int32"):
        bfs_bitpack.bitpack_query_call(occ, env, cls, base, tgt.long(), pos, 9, 8, 4)
    with pytest.raises(ValueError, match="16-byte"):
        bfs_pallas.query_call(occ.contiguous(), env, cls, base, tgt, pos, 9, 8, 4)
    with pytest.raises(ValueError, match="base must be"):
        bfs_pallas.query_call(occ, env, cls, base[:1], tgt, pos, 9, 8, 4)
    with pytest.raises(ValueError, match="one device"):
        bfs_pallas.query_call(occ, env, cls, base, tgt.cpu(), pos, 9, 8, 4)
    with pytest.raises(ValueError, match="W\\+1 < 32"):
        bfs_bitpack.bitpack_query_call(occ, env, cls, base, tgt, pos, 3, 31, 4)
    # A row of 630,700 cells needs 12 bytes a word in the shared-memory form.
    big = bfs_pallas.walled_rows(torch.zeros(2, 700, 900, dtype=torch.bool, device=cuda))
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        bfs_pallas.query_call(big, one, one, big, one, one, 700, 900, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(20, 40), (16, 63), (150, 150)])  # Ws 41, 64 (whole words), 151
def test_int32_query_at_wide_rows(cuda, H, W):
    """K2 at walled widths of 32 and more (the shared-memory form), which K1
    refuses."""
    _check_query("K2", _random_envs(H, W, 8, 256, seed=H * W), H, W, 2 * (H + W), cuda)


@pytest.mark.cuda
def test_queries_stop_early_without_changing_the_answer(cuda):
    """200 sweeps give the plain version's answer, and the 32-sweep answer
    wherever every probe settles within 32 sweeps (the early exits); rows
    where nothing is reachable (an env index outside the batch: every cell
    occupied) give (INF, -1) at any sweep count."""
    H, W = 25, 22
    args = _random_envs(H, W, 64, 2048, seed=3)
    for kernel in QUERIES:
        d200, nd200 = _check_query(kernel, args, H, W, 200, cuda)
        d32, nd32 = _check_query(kernel, args, H, W, 32, cuda)
        settled = d32 < bfs_pallas.INF
        assert settled.float().mean() > 0.5
        assert torch.equal(d32[settled], d200[settled]) and torch.equal(nd32[settled], nd200[settled])
        assert (d200[~settled] > 32).any()  # reached only beyond 32 sweeps
    occ, env, cls, base, tgt, pos = args
    cut = (occ, torch.full_like(env, -1), cls, base, tgt, pos)
    apart = ~torch.isin((tgt - pos).abs(), torch.tensor([0, 1, W + 1]))
    for kernel in QUERIES:
        for iters in (1, 32, 200):
            d, nd = _check_query(kernel, cut, H, W, iters, cuda)
            assert (d[apart] == bfs_pallas.INF).all() and (nd[apart] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 40])
@pytest.mark.parametrize("H,W", [(9, 8), (25, 22)])
def test_queries_on_every_target(cuda, H, W, iters):
    """Each query against its own plain version for every walled target in
    [-3(W+1), L + 3(W+1)) of its padded row L, and -1, INT32_MIN,
    INT32_MAX: in the grid, in the margin row below it, in the padding whose
    neighbours wrap to row 0, and far out."""
    Ws = W + 1
    for kernel, L in (("K1", 32 * bfs_bitpack._plan(H, W)[2]),
                      ("K2", bfs_pallas.query_length(H, W))):
        ts = torch.cat([torch.arange(-3 * Ws, L + 3 * Ws), torch.tensor([-1, -2**31, 2**31 - 1])])
        occ, env, cls, base, _, pos = _random_envs(H, W, 16, ts.shape[0], seed=L + iters)
        _check_query(kernel, (occ, env, cls, base, ts.int(), pos), H, W, iters, cuda)


@pytest.mark.cuda
def test_replan_query_launches_without_a_host_sync_or_a_mask(cuda, monkeypatch):
    """The compacted replan query on the card: the kernel builds the rows,
    so `_passable_rows` is never called, and nothing waits for the device."""
    H, W, B, A = 25, 22, 64, 28
    occ, env, cls, base, tgt, pos = _to(_random_envs(H, W, B, B * A, seed=5), cuda)
    calls = []
    monkeypatch.setattr(bfs_pallas, "_passable_rows", lambda *a: calls.append(a))
    need = torch.rand(B, A, device=cuda) < 0.3
    torch.cuda.synchronize()
    for kernel, query in (("K1", bfs_bitpack.bitpack_query_call), ("K2", bfs_pallas.query_call)):
        torch.cuda.set_sync_debug_mode("error")
        try:
            d, nd, overflow = bfs_pallas.bfs_query_occ_batched(
                occ, tgt.view(B, A), pos.view(B, A), cls[:A], need, base, H, W, 32,
                row_frac=0.5, rows_per_block=128, query=query)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert d.shape == nd.shape == (B, A) and int(overflow.sum()) == 0, kernel
    assert calls == []


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(25, 22), (9, 8), (80, 30)])
def test_bfs_dist_matches_plain(cuda, H, W):
    """K3 vs its plain version: random grids, targets on every edge and
    corner, one target on a blocked cell; bit for bit."""
    g = torch.Generator().manual_seed(H * W)
    K = 256
    pas = torch.rand(K, H, W, generator=g) < 0.75
    ty, tx = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    ty[0::5], tx[1::5], ty[2::5], tx[3::5] = 0, 0, H - 1, W - 1
    pas[torch.arange(K), ty, tx] = True
    pas[4, ty[4], tx[4]] = False
    tgt = (ty * W + tx).int()
    for iters in (4, 40):
        ref = bfs_pallas.bfs_dist_plain(pas, tgt, iters)
        before = bfs_pallas.DIST_LAUNCHES
        got = bfs_pallas.bfs_dist_call(pas.to(cuda), tgt.to(cuda), iters)
        torch.cuda.synchronize()
        assert bfs_pallas.DIST_LAUNCHES == before + 1
        assert torch.equal(got.cpu(), ref)


def _random_fields(H, W, K, seed, impassable_targets=False):
    """Random (K, H, W) grids, targets on every edge and corner; every
    target impassable when asked (it still starts at 0)."""
    g = torch.Generator().manual_seed(seed)
    pas = torch.rand(K, H, W, generator=g) < 0.75
    ty, tx = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    ty[0::5], tx[1::5], ty[2::5], tx[3::5] = 0, 0, H - 1, W - 1
    pas[torch.arange(K), ty, tx] = not impassable_targets
    return pas, (ty * W + tx).int()


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,iters", [
    (33, 31, 80),  # Ws = 32: whole-word +-Ws carries, no shift by 32
    (12, 63, 60),  # Ws = 64
    (7, 100, 120),  # Ws = 101: two words and 5 bits
    (150, 150, 600),  # 708 words: the rows live in shared memory
    (25, 22, 0), (25, 22, 1), (25, 22, 200),  # no sweep, one, past the diameter
])
def test_bfs_dist_widths_and_sweeps(cuda, H, W, iters):
    """K3 vs its plain version, bit for bit, at walled widths of 32 and more,
    on a grid whose row is longer than a warp's registers hold, and with 0,
    1 and more sweeps than any distance needs (the early exit)."""
    pas, tgt = (t.to(cuda) for t in _random_fields(H, W, 64 if H * W > 10000 else 256,
                                                   seed=H + W + iters))
    ref = bfs_pallas.bfs_dist_plain(pas, tgt, iters)  # on the card: 600 sweeps of 150x150
    got = bfs_pallas.bfs_dist_call(pas, tgt, iters)
    assert torch.equal(got, ref)
    if iters >= 200:
        assert (ref > 32).any()  # the field is reached beyond K1's sweep budget


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 40])
def test_bfs_dist_impassable_and_out_of_range_targets(cuda, iters):
    """Targets on impassable cells (0 there, 1 at their passable
    neighbours), and the sweep of out-of-range targets: below the grid, in
    the wall row, in the padding that wraps to row 0, and the int32
    extremes."""
    for H, W in ((9, 8), (25, 22)):
        pas, tgt = _random_fields(H, W, 256, seed=iters, impassable_targets=True)
        ref = bfs_pallas.bfs_dist_plain(pas, tgt, iters)
        assert (ref.view(256, -1).gather(1, tgt.long()[:, None]) == 0).all()
        assert torch.equal(bfs_pallas.bfs_dist_call(pas.to(cuda), tgt.to(cuda), iters).cpu(), ref)
        ts = torch.cat([torch.arange(-3 * W, 2 * H * W + 5 * W, dtype=torch.int32),
                        torch.tensor([-2**31, 2**31 - 1, 2**30], dtype=torch.int32)])
        pas = torch.rand(ts.shape[0], H, W, generator=torch.Generator().manual_seed(H)) < 0.8
        ref = bfs_pallas.bfs_dist_plain(pas, ts, iters)
        assert torch.equal(bfs_pallas.bfs_dist_call(pas.to(cuda), ts.to(cuda), iters).cpu(), ref)


@pytest.mark.cuda
def test_queries_on_margin_row_targets(cuda):
    """K1 and K2 against their plain versions for targets in the margin row
    below the grid, which reach the grid's last row (and, for K1 where
    t + W+1 passes its 32*words bits, row 0 across the wrap)."""
    H, W = 25, 22
    Ws, n = W + 1, 25 * 23
    occ, env, cls, base, _, pos = _random_envs(H, W, 16, 2 * Ws * 8, seed=11)
    tgt = (n + torch.arange(env.shape[0]) % Ws).int()
    for kernel in QUERIES:
        d, _ = _check_query(kernel, (occ, env, cls, base, tgt, pos), H, W, 40, cuda)
        assert (d < bfs_pallas.INF).any()


@pytest.mark.cuda
def test_bfs_dist_rejects_a_grid_beyond_shared_memory(cuda):
    pas = torch.ones(1, 400, 400, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        bfs_pallas.bfs_dist_call(pas, torch.zeros(1, dtype=torch.int32, device=cuda), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 64, 435])
def test_segment_sum_matches_plain(cuda, D):
    """K4 vs its plain version, with invalid, negative and too-large ids.
    Within 1e-5 absolute on sums of a few dozen unit-scale terms; K4 sums
    each bucket in edge order, as the plain version does on the CPU, so the
    design expects 0."""
    g = torch.Generator().manual_seed(D)
    E, N = 5000, 300
    data = torch.randn(E, D, generator=g)
    ids = torch.randint(-5, N + 5, (E,), generator=g).int()
    valid = torch.rand(E, generator=g) < 0.8
    ref = segment_pallas.segment_sum_plain(data, ids, N, valid)
    before = segment_pallas.LAUNCHES
    got = segment_pallas.segment_sum_call(data.to(cuda), ids.to(cuda), N, valid.to(cuda))
    torch.cuda.synchronize()
    assert segment_pallas.LAUNCHES == before + 1
    assert (got.cpu() - ref).abs().max().item() <= 1e-5
    no_mask = segment_pallas.segment_sum_call(data.to(cuda), ids.to(cuda), N)
    ref_all = segment_pallas.segment_sum_plain(data, ids, N)
    assert (no_mask.cpu() - ref_all).abs().max().item() <= 1e-5


@pytest.mark.cuda
def test_new_wrappers_reject_what_the_kernels_cannot_take(cuda):
    pas = torch.ones(4, 5, 6, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        bfs_pallas.bfs_dist_call(pas, torch.zeros(4, dtype=torch.int64, device=cuda), 3)
    data = torch.ones(8, 3, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        segment_pallas.segment_sum_call(data, torch.zeros(8, dtype=torch.int64, device=cuda), 2)
    with pytest.raises(ValueError, match="float32"):
        segment_pallas.segment_sum_call(data.double(), torch.zeros(8, dtype=torch.int32, device=cuda), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 435])
def test_planned_segment_sum_matches_plain(cuda, D):
    """The served form: K4 through a plan whose rows are the edges' sources
    (the gather fused), sum and mean, planned and launched with no host
    synchronisation. Bit for bit against the plain version on the CPU (both
    sum each bucket in edge order and divide by the same count), and two
    launches give the same bits. The general form (segment_sum_call) too."""
    g = torch.Generator().manual_seed(D + 1)
    R, E, N = 700, 5000, 300
    x = torch.randn(R, D, generator=g)
    src = torch.randint(0, R, (E,), generator=g).int()
    dst = torch.randint(-5, N + 5, (E,), generator=g).int()
    valid = torch.rand(E, generator=g) < 0.8
    plan = segment_pallas.segment_plan(dst, valid, N, rows=src, num_rows=R)
    xg, dg, vg, sg = (t.to(cuda) for t in (x, dst, valid, src))
    torch.cuda.synchronize()
    before = segment_pallas.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        gplan = segment_pallas.segment_plan(dg, vg, N, rows=sg, num_rows=R)
        runs = [segment_pallas.segment_sum_planned(xg, *gplan, mean=mean)
                for mean in (False, True, False, True)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert segment_pallas.LAUNCHES == before + 4
    assert all(torch.equal(a.cpu(), b) for a, b in zip(gplan, plan))
    for k, mean in enumerate((False, True)):
        ref = segment_pallas.segment_sum_planned(x, *plan, mean=mean)
        assert torch.equal(runs[k], runs[k + 2])
        assert torch.equal(runs[k].cpu(), ref)
    msgs = x[src.long()]
    got = segment_pallas.segment_sum_call(msgs.to(cuda), dst.to(cuda), N, valid.to(cuda))
    assert torch.equal(got.cpu(), segment_pallas.segment_sum_plain(msgs, dst, N, valid))


@pytest.mark.cuda
def test_planned_wrapper_rejects_what_k4_cannot_take(cuda):
    data = torch.ones(8, 3, device=cuda)
    row = torch.zeros(8, dtype=torch.int32, device=cuda)
    offsets = torch.tensor([0, 4, 8], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="row must be"):
        segment_pallas.segment_sum_planned(data, row.long(), offsets)
    with pytest.raises(ValueError, match="offsets must be"):
        segment_pallas.segment_sum_planned(data, row, offsets.long())
    with pytest.raises(ValueError, match="offsets must be"):
        segment_pallas.segment_sum_planned(data, row, offsets[None])
    with pytest.raises(ValueError, match="offsets must be"):
        segment_pallas.segment_sum_planned(data, row, offsets[:0])
    with pytest.raises(ValueError, match="float32"):
        segment_pallas.segment_sum_planned(data.double(), row, offsets)
    with pytest.raises(ValueError, match="one device"):
        segment_pallas.segment_sum_planned(data, row, offsets.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        segment_pallas.segment_sum_planned(torch.ones(3, 8, device=cuda).t(), row, offsets)


def _train_data(seed=0, E=4, T=40, N=6, D=24):
    """E episodes of T steps of random integral observations (positions in
    features 0-4), as GDE training data."""
    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset

    g = torch.Generator().manual_seed(seed)
    eps = [torch.randint(0, 12, (T, N, D), generator=g).float().numpy() for _ in range(E)]
    return TrajectoryDataset(episodes=eps, num_agvs=3, num_pickers=N - 3, seq_len=5)


@pytest.mark.cuda
@pytest.mark.parametrize("horizon,weights", [(1, None), (4, (3.0, 1.0, 1.0, 1.0))])
def test_train_step_matches_cpu(cuda, horizon, weights):
    """One training step from the same parameters on the same 16 windows:
    the loss within 1e-5 and each gradient within 1e-5 of its largest
    element (float32 sums in other orders), card against CPU; AdamW on the
    card from the CPU's clipped gradients within 1e-6 of the CPU's. The
    step (window gather, loss, backward, clip, AdamW) runs with host
    synchronisation forbidden."""
    import copy

    import numpy as np

    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.train import train_gde as tg

    ds = _train_data()
    pos = np.stack(ds._positions)
    pos = np.pad(pos, ((0, 0), (0, horizon), (0, 0), (0, 0)), mode="edge")
    pairs = torch.from_numpy(np.asarray(ds._index, np.int32)[::10][:16].copy())
    cfg = tg.GDETrainConfig()
    model = GraphODE(24, 3, 3, 16).init_(torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        m = copy.deepcopy(model).to(dev)
        params = list(m.parameters())
        data = {"episodes": torch.from_numpy(np.stack(ds.episodes)).to(dev),
                "positions": torch.from_numpy(pos).to(dev)}
        loss_fn = tg._batch_loss(m, 3, 5.0, horizon, weights)
        batch = tg.window_batch(data, pairs.to(dev), 5, horizon, 40)
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, params)
        clipped = tg.clip_by_global_norm(grads, cfg.grad_clip)
        out[dev] = loss.detach(), [g.cpu() for g in grads], clipped
        if dev != "cpu":
            opt = tg.adamw_init(params)
            dev_pairs = pairs.to(dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                opt, _ = tg.train_step(params, opt, loss_fn,
                                       tg.window_batch(data, dev_pairs, 5, horizon, 40), cfg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert int(opt.count) == 1
    (lc, gc, cc), (lg, gg, _) = out["cpu"], out[cuda]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    cpu_m, card_m = copy.deepcopy(model), copy.deepcopy(model).to(cuda)
    cp, gp = list(cpu_m.parameters()), list(card_m.parameters())
    with torch.no_grad():
        tg.adamw_update(cp, cc, tg.adamw_init(cp), cfg.lr, cfg.weight_decay)
        tg.adamw_update(gp, [c.to(cuda) for c in cc], tg.adamw_init(gp), cfg.lr, cfg.weight_decay)
    for a, b in zip(gp, cp):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_train_gde_on_the_card(cuda, tmp_path):
    """train_gde on the card (default device), resident uint8 data and
    checkpoints: 2 epochs, finite falling loss; a resume with nothing left
    to train gives back the final parameters bit for bit."""
    import numpy as np

    from swarm_ode_tpu_torch.train import train_gde as tg

    ds = _train_data(T=60)
    cfg = tg.GDETrainConfig(num_epochs=2, batch_size=16, hidden_dim=16, device_dtype="uint8",
                            checkpoint_dir=str(tmp_path), checkpoint_every=1)
    out = tg.train_gde(ds, cfg, verbose=False)
    hist = out["history"]["train_loss"]
    assert next(out["model"].parameters()).device.type == "cuda"
    assert all(np.isfinite(hist)) and hist[1] < hist[0]
    again = tg.train_gde(ds, cfg, verbose=False)
    assert all(torch.equal(v, out["final_params"][k]) for k, v in again["final_params"].items())


MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"


def _medium(device):
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import make_params

    cfg = EnvConfig.from_env_id(MEDIUM)
    lay = build_layout(cfg)
    return make_params(cfg, lay, device), lay


def _same(a, b):
    """Two tensors, or two dataclasses of tensors, equal bit for bit."""
    import dataclasses

    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [1.0, 0.37])
def test_experts_and_masks_card_equal_cpu(cuda, temperature):
    """From one reset, with the same step and dispatcher draws made on the
    CPU: the stochastic expert, the stateless expert and the action masks
    on the card equal the CPU's at every step, and K1 runs once a step.
    At T = 0.37 the division by the temperature is inexact: the card must
    divide as the CPU does."""
    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.env import observations as obs_mod
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.policies import heuristic as heur

    B, T = 8, 20
    runs = {}
    for dev in ("cpu", cuda):
        pp, lay = _medium(dev)
        g = torch.Generator().manual_seed(4)
        pcpu, _ = _medium("cpu")
        s = convert.env_state_to(step_mod.reset(pcpu, B, g), dev)
        draws = [(step_mod.draw_noise(pcpu, B, g), heur.draw_dispatch_noise(pcpu, B, g))
                 for _ in range(T)]
        stoch = heur.make_policy(pp, lay, temperature=temperature)
        expert = heur.make_stateless_expert(pp, lay)
        h = heur.init_state(pp, B)
        before = bfs_bitpack.LAUNCHES
        out = []
        for n, dn in draws:
            n = step_mod.StepNoise(None, n.delivery_gumbel.to(dev))
            dn = heur.DispatchNoise(dn.assign.to(dev), dn.goal.to(dev), dn.ret.to(dev))
            a, h = stoch(pp, s, h, dn)
            out.append((a, expert(pp, s), obs_mod.compute_valid_action_masks(pp, s), h))
            s, *_ = step_mod.step(pp, s, a, noise=n)
        runs[str(dev)] = out, s, bfs_bitpack.LAUNCHES - before
    (cpu, s_cpu, _), (card, s_card, k1) = runs["cpu"], runs[str(cuda)]
    for t, (x, y) in enumerate(zip(cpu, card)):
        assert all(_same(a, b) for a, b in zip(x, y)), f"step {t}"
    assert _same(s_cpu, s_card) and k1 == T


@pytest.mark.cuda
def test_collect_batch_card_equal_cpu(cuda):
    """collect_batch's captured arrays on the card equal the CPU's, every
    key (observations as float16 bits), chunks of 6 over 15 steps."""
    import numpy as np

    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.data.collect import collect_batch
    from swarm_ode_tpu_torch.env import step as step_mod

    B, T = 8, 15
    pcpu, lay = _medium("cpu")
    g = torch.Generator().manual_seed(6)
    s = step_mod.reset(pcpu, B, g)
    noise = [step_mod.draw_noise(pcpu, B, g) for _ in range(T)]
    want, _ = collect_batch(pcpu, lay, B, T, 6, state=s, noise=noise)
    pgpu, _ = _medium(cuda)
    got, stats = collect_batch(
        pgpu, lay, B, T, 6, state=convert.env_state_to(s, cuda),
        noise=[step_mod.StepNoise(None, n.delivery_gumbel.to(cuda)) for n in noise])
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(
            want[k].view(np.uint16) if want[k].dtype == np.float16 else want[k],
            got[k].view(np.uint16) if got[k].dtype == np.float16 else got[k]), k
    assert int(stats["replan_overflow"].sum()) == 0


@pytest.mark.cuda
def test_auto_reset_rollout_on_the_card_without_a_host_sync(cuda):
    """Episodes of 10 steps over 25 at B = 16 on the card: the loop runs
    with host synchronisation forbidden; two boundaries per env."""
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import env as env_mod
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.policies import heuristic as heur

    cfg = EnvConfig.from_env_id(MEDIUM, max_steps=10)
    lay = build_layout(cfg)
    pp = make_params(cfg, lay, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    policy = heur.make_policy(pp, lay)
    s, h = step_mod.reset(pp, 16, g), heur.init_state(pp, 16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, h, (_, done, _) = env_mod.auto_reset_rollout(
            pp, policy, lambda b: heur.init_state(pp, b), s, h, 25, generator=g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (done.sum(1) == 2).all() and (s.cur_steps == 5).all()


@pytest.mark.cuda
def test_gym_episode_on_the_card(cuda):
    """The gym adapter on the card (the default device): terminateds at the
    last step and not before; heuristic_episode delivers."""
    import swarm_ode_tpu_torch
    from swarm_ode_tpu_torch.policies import heuristic as heur

    env = swarm_ode_tpu_torch.make("tarware-tiny-3agvs-2pickers-partialobs-v1", max_steps=30)
    assert env.params.device.type == "cuda"
    env.reset(seed=0)
    for t in range(30):
        _, _, term, trunc, _ = env.step([0] * env.num_agents)
        assert all(term) == (t == 29) and term == trunc
    infos, ret, ep = heur.heuristic_episode(swarm_ode_tpu_torch.make(
        "tarware-tiny-3agvs-2pickers-partialobs-v1"), seed=0)
    assert len(infos) == 500 and sum(i["shelf_deliveries"] for i in infos) > 3


def _marl_tree_to(x, device):
    """Nested dicts, lists, named tuples and dataclasses of tensors, moved."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _marl_tree_to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_marl_tree_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_marl_tree_to(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _marl_tree_to(getattr(x, f.name), device)
                          for f in dataclasses.fields(x)})
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["tarware-tiny-3agvs-2pickers-partialobs-v1", MEDIUM])
def test_marl_pieces_card_vs_cpu(cuda, env_id):
    """The MARL path's pieces on the card against the CPU (the twins of
    test_torch_hetero, _qnets, _coordination, _replay and _learn): graphs,
    masks_from_feats, busy flags, replay samples and selections identical;
    Q-values of every network within 1e-5 of the largest |Q|; one IQL and
    one QMIX learn step (n_step 3, value_transform, coordinated) with the
    loss within 1e-5, the gradient within 1e-5 of its largest element and
    Adam on the card from the CPU's gradients within 1e-6."""
    import dataclasses

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.observations import compute_valid_action_masks, observe
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.graphs import hetero
    from swarm_ode_tpu_torch.rl import coordination, replay
    from swarm_ode_tpu_torch.rl.dqn import ActNoise, epsilon_greedy, q_values
    from swarm_ode_tpu_torch.train import run_rl
    from swarm_ode_tpu_torch.utils.optim import adamw_update, clip_by_global_norm

    cfg = EnvConfig.from_env_id(env_id)
    lay = build_layout(cfg)
    pc, pg = make_params(cfg, lay, "cpu"), make_params(cfg, lay, cuda)
    g = torch.Generator().manual_seed(4)
    s = step_mod.reset(pc, 4, g)
    obs = []
    for t in range(20):
        m = compute_valid_action_masks(pc, s)
        s = step_mod.step(pc, s, (torch.rand(m.shape, generator=g) * m).argmax(-1).int(),
                          generator=g)[0]
        obs.append(observe(pc, s))
    obs = torch.cat(obs[4::5])
    feats = [hetero.split_observation(p, o) for p, o in ((pc, obs), (pg, obs.to(cuda)))]
    ref, got = ({**vars(hetero.hetero_graph_from_obs(p, o)),
                 "masks": hetero.masks_from_feats(p, *f),
                 "busy": coordination.busy_from_feats(*f[:2])}
                for p, o, f in ((pc, obs, feats[0]), (pg, obs.to(cuda), feats[1])))
    for k in ref:
        assert torch.equal(got[k].cpu(), ref[k]), k
    for net in ("gnn", "gnode", "gnode_comm"):
        rcfg = run_rl.RLRunConfig(env_id=env_id, net=net, hidden_dim=32, device="cpu")
        _, nc = run_rl.make_agent(rcfg, pc)
        nc.init_(torch.Generator().manual_seed(1))
        _, ng = run_rl.make_agent(dataclasses.replace(rcfg, device="cuda"), pg)
        ng.load_state_dict(nc.state_dict())
        with torch.no_grad():
            qc = q_values(nc, dict(nc.named_parameters()), hetero.hetero_graph_from_obs(pc, obs))
            qg = q_values(ng, dict(ng.named_parameters()),
                          hetero.hetero_graph_from_obs(pg, obs.to(cuda)))
        assert float((qg.cpu() - qc).abs().max()) <= 1e-5 * float(qc.abs().max()), net
    active, eps = ~ref["busy"], torch.tensor(0.5)
    for coordinated in (False, True):
        row = torch.rand(qc.shape, generator=g) if coordinated else step_mod.draw_gumbel(
            qc.shape, g, "cpu")
        nz = ActNoise(torch.rand(qc.shape[:2], generator=g), row)
        want = epsilon_greedy(qc, ref["masks"], eps, nz, pc, coordinated, active)
        out = epsilon_greedy(qc.to(cuda), ref["masks"].to(cuda), eps.to(cuda),
                             _marl_tree_to(nz, cuda), pg, coordinated, active.to(cuda))
        assert torch.equal(out.cpu(), want)
        out = coordination.coordinated_sample(qc.to(cuda), ref["masks"].to(cuda), pg.num_agvs,
                                              1 + pg.num_goals, row.to(cuda), active.to(cuda))
        assert torch.equal(out.cpu(), coordination.coordinated_sample(
            qc, ref["masks"], pc.num_agvs, 1 + pc.num_goals, row, active))

    base = run_rl.RLRunConfig(env_id=env_id, num_envs=4, hidden_dim=32, buffer_size=64,
                              batch_size=16, n_step=3, value_transform=True, coordinated=True,
                              device="cpu")
    run = run_rl.MarlRun(base)
    es = run.draws.reset(4)
    o = observe(pc, es)
    for t in range(20):  # 80 items: the ring wraps
        es, o, _ = run.env_step(es, o, t, 0)
    buf_g = replay.ReplayBuffer(_marl_tree_to(run.buf.storage, cuda), run.buf.ptr, run.buf.size)
    idx = torch.randint(0, run.buf.size, (16,), generator=g)
    sampled = replay.sample_nstep(run.buf, 16, 3, 4, idx=idx)
    sampled_g = replay.sample_nstep(buf_g, 16, 3, 4, idx=idx.to(cuda))
    for (k, v), (k2, w) in zip(_flat(sampled), _flat(sampled_g)):
        assert k == k2 and torch.equal(w.cpu(), v), k
    for algo in ("iql", "qmix"):
        acfg = dataclasses.replace(base, algo=algo)
        ac, _ = run_rl.make_agent(acfg, pc)
        ag, _ = run_rl.make_agent(dataclasses.replace(acfg, device="cuda"), pg)
        st = ac.init(torch.Generator().manual_seed(2))
        batch = run_rl.batch_from(sampled, algo, ac.cfg.gamma, 3)
        nc_, auxc, grc = ac.learn_with_grads(st, batch)
        ng_, auxg, grg = ag.learn_with_grads(_marl_tree_to(st, cuda), _marl_tree_to(batch, cuda))
        assert abs(float(auxg["loss"]) - float(auxc["loss"])) <= 1e-5 * abs(float(auxc["loss"]))
        scale = max(float(v.abs().max()) for v in grc.values())
        for k in grc:
            assert float((grg[k].cpu() - grc[k]).abs().max()) <= 1e-5 * scale, k
        # Adam on the card from the CPU's clipped gradients (from its own,
        # a gradient near Adam's 1e-8 amplifies rounding; chip_smoke prints
        # that difference).
        names = list(st.params)
        clipped = clip_by_global_norm([grc[k] for k in names], ac.cfg.grad_clip)
        on_card = [st.params[k].to(cuda).clone() for k in names]
        adamw_update(on_card, [c.to(cuda) for c in clipped], _marl_tree_to(st.opt_state, cuda),
                     ac.cfg.lr, 0.0)
        for p, k in zip(on_card, names):
            assert float((p.cpu() - nc_.params[k]).abs().max()) <= 1e-6, k


def _flat(tree, prefix=""):
    """[(path, tensor)] of a nested dict of tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat(v, f"{prefix}{k}/")]
    return [(prefix, tree)]


@pytest.mark.cuda
def test_run_marl_on_the_card_without_a_host_sync(cuda, tmp_path):
    """run_marl on the card (its default device) for one stride of 2 tiny
    envs with host synchronisation forbidden in the episode: K1 once a step,
    a finite nonzero loss; an eval-only run resuming from the checkpoint
    restores the agent bit for bit; the trained Q-network served through
    make_policy_fn(coordinated=True)."""
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.serving import make_policy_fn
    from swarm_ode_tpu_torch.train import run_rl

    cfg = run_rl.RLRunConfig(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1", num_envs=2,
                             num_episodes=2, hidden_dim=16, batch_size=16, learn_every=5,
                             checkpoint_dir=str(tmp_path), checkpoint_every=2,
                             forbid_host_sync=True)
    bfs_bitpack.LAUNCHES = 0
    out = run_rl.run_marl(cfg, verbose=False)
    assert bfs_bitpack.LAUNCHES == 500
    stats = out["history"][0]
    assert stats["loss"] != 0.0 and torch.isfinite(torch.tensor(out["losses"][0])).all()
    assert stats["replan_overflow"] == 0
    ev = run_rl.run_marl(run_rl.RLRunConfig(**{
        **vars(cfg), "num_episodes": 0, "eval_episodes": 2, "resume_from": str(tmp_path),
        "checkpoint_dir": None, "forbid_host_sync": False}), verbose=False)
    st, rs = out["agent_state"], ev["agent_state"]
    for k in st.params:
        assert torch.equal(st.params[k], rs.params[k]) and torch.equal(
            st.target_params[k], rs.target_params[k])
    assert torch.equal(st.epsilon, rs.epsilon) and torch.equal(st.step, rs.step)
    run = run_rl.MarlRun(cfg, agent_state=st)
    policy = make_policy_fn(run.params, run.net, run_rl.agent_params(st), coordinated=True)
    s = step_mod.reset(run.params, 3, torch.Generator(device=cuda).manual_seed(0))
    a = policy(observe(run.params, s))
    assert a.shape == (3, run.params.num_agents) and a.device.type == "cuda"


@pytest.mark.cuda
def test_learning_from_the_dispatcher_on_the_card(cuda, tmp_path):
    """The paths that learn from the dispatcher, on the card (their default
    device), tiny: train_bc on recorded expert episodes with a checkpoint;
    collect_dagger, evaluate_policy, run_mappo warm-started from the clone
    (its collection with host synchronisation forbidden) and
    run_marl(algo="coma") (its episode likewise) each launch K1 once a step
    with overflow 0; QMIX built with init_q_from holds the clone."""
    import numpy as np

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.data.collect import collect_batch
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.rl import ppo
    from swarm_ode_tpu_torch.train import run_rl
    from swarm_ode_tpu_torch.train import train_bc as bc

    tiny = "tarware-tiny-3agvs-2pickers-partialobs-v1"
    cfg = EnvConfig.from_env_id(tiny)
    lay = build_layout(cfg)
    pp = make_params(cfg, lay)
    g = torch.Generator(device=cuda).manual_seed(0)
    traj, _ = collect_batch(pp, lay, 4, 100, 50, g)
    flat = lambda k: traj[k].reshape((400,) + traj[k].shape[2:])
    arrays = (flat("observations").astype(np.float16), flat("actions").astype(np.int32),
              flat("agent_busy"), np.repeat(np.arange(4, dtype=np.int32), 100))
    clone = bc.train_bc(bc.BCConfig(env_id=tiny, net="gnn", hidden_dim=16, epochs=2,
                                    batch_size=16, val_frac=0.25,
                                    checkpoint_dir=str(tmp_path / "bc")),
                        verbose=False, arrays=arrays)
    assert np.isfinite(clone["history"][-1]["train_loss"])
    bfs_bitpack.LAUNCHES = 0
    *_, st = bc.collect_dagger(pp, lay, clone["net"], clone["params"], 2, g, beta=0.25,
                               steps=40, with_stats=True)
    assert bfs_bitpack.LAUNCHES == 40 and st["replan_overflow"] == 0
    bfs_bitpack.LAUNCHES = 0
    ev = bc.evaluate_policy(pp, clone["net"], clone["params"], 2, g, coordinated=True,
                            verbose=False)
    assert bfs_bitpack.LAUNCHES == 500 and ev["replan_overflow"] == 0
    mcfg = ppo.MAPPOConfig(env_id=tiny, net="gnn", hidden_dim=16, num_envs=2, num_strides=1,
                           steps_override=20, minibatch=8, init_from=str(tmp_path / "bc"),
                           forbid_host_sync=True)
    run = ppo.MappoRun(mcfg)
    assert all(torch.equal(run.actor_params[k], v) for k, v in clone["params"].items())
    bfs_bitpack.LAUNCHES = 0
    h = ppo.run_mappo(mcfg, verbose=False, run=run)["history"][0]
    assert bfs_bitpack.LAUNCHES == 20 and h["replan_overflow"] == 0
    assert np.isfinite([h["pg_loss"], h["v_loss"], h["entropy"]]).all()
    ccfg = run_rl.RLRunConfig(env_id=tiny, algo="coma", net="gnn", num_envs=2, num_episodes=2,
                              hidden_dim=16, batch_size=16, learn_every=5, coma_updates=2,
                              coordinated=True, forbid_host_sync=True)
    bfs_bitpack.LAUNCHES = 0
    h = run_rl.run_marl(ccfg, verbose=False)["history"][0]
    assert bfs_bitpack.LAUNCHES == 500 and h["replan_overflow"] == 0
    assert np.isfinite([h["critic_loss"], h["actor_loss"]]).all()
    q = run_rl.MarlRun(run_rl.RLRunConfig(env_id=tiny, algo="qmix", net="gnn", num_envs=2,
                                          hidden_dim=16, init_q_from=str(tmp_path / "bc")))
    for k, v in clone["params"].items():
        assert torch.equal(q.astate.params[f"q.{k}"], v)
        assert torch.equal(q.astate.target_params[f"q.{k}"], v)


@pytest.mark.cuda
@pytest.mark.parametrize("coordinated", [False, True])
def test_coma_update_card_vs_cpu(cuda, coordinated):
    """One COMA update (counterfactual baseline) on the card against the
    CPU from the same state and batch: both losses within 1e-5, both
    gradients within 1e-5 of their largest element."""
    import dataclasses

    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.rl import replay
    from swarm_ode_tpu_torch.train import run_rl

    cfg = run_rl.RLRunConfig(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1", algo="coma",
                             num_envs=4, hidden_dim=16, buffer_size=128, batch_size=16,
                             coordinated=coordinated, device="cpu")
    run = run_rl.MarlRun(cfg)
    es = run.draws.reset(4)
    o = observe(run.params, es)
    for t in range(20):
        es, o, _ = run.env_step(es, o, t, 0)
    s = replay.sample_recent(run.buf, 16, 80, off=torch.arange(1, 17) * 3)
    batch = {"obs_feats": s["obs_feats"], "global_state": s["global_state"],
             "actions": s["actions"], "rewards": s["rewards"].mean(-1),
             "next_global_state": s["next_global_state"], "dones": s["done"]}
    _, aux_c, gr_c = run.agent.update_with_grads(run.astate, batch)
    agent_g, _ = run_rl.make_agent(dataclasses.replace(cfg, device="cuda"),
                                   run_rl.MarlRun(dataclasses.replace(
                                       cfg, device="cuda", buffer_size=8)).params)
    _, aux_g, gr_g = agent_g.update_with_grads(_marl_tree_to(run.astate, cuda),
                                               _marl_tree_to(batch, cuda))
    for k in aux_c:
        assert abs(float(aux_g[k]) - float(aux_c[k])) <= 1e-5 * abs(float(aux_c[k])), k
    for part in ("critic", "actor"):
        scale = max(float(v.abs().max()) for v in gr_c[part].values())
        for k, v in gr_c[part].items():
            assert float((gr_g[part][k].cpu() - v).abs().max()) <= 1e-5 * scale, (part, k)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gru", "lstm", "pos_gru", "pos_lstm"])
def test_baseline_step_card_vs_cpu(cuda, model):
    """One baseline loss and its gradients on the card against the CPU from
    the same parameters and windows (TF32 off): the loss within 1e-5 of
    itself, each gradient within 1e-5 of its largest element; a train step
    with host synchronisation forbidden."""
    import copy

    import numpy as np

    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
    from swarm_ode_tpu_torch.train import train_baselines as tb
    from swarm_ode_tpu_torch.train import train_gde as tg
    from swarm_ode_tpu_torch.utils.optim import adamw_init

    rng = np.random.RandomState(0)
    eps = [rng.randint(0, 9, size=(30, 5, 19)).astype(np.float32) for _ in range(3)]
    ds = TrajectoryDataset(episodes=eps, num_agvs=3, num_pickers=2, seq_len=5)
    m_cpu = tb.MODEL_FACTORIES[model](ds, 32).init_(torch.Generator().manual_seed(1))
    pairs = torch.from_numpy(np.asarray(ds._index, np.int32)[rng.choice(len(ds), 16)])
    out = {}
    for dev in ("cpu", cuda):
        m = copy.deepcopy(m_cpu).to(dev)
        data = {"episodes": torch.from_numpy(np.stack(eps)).to(dev),
                "positions": torch.from_numpy(np.stack(ds._positions)).to(dev)}
        loss = tb.baseline_loss(m, model.startswith("pos_"))(
            tg.window_batch(data, pairs.to(dev), 5, with_pos=True))
        out[dev] = (loss.detach(), torch.autograd.grad(loss, list(m.parameters())), m, data)
    (lc, gc, _, _), (lg, gg, m, data) = out["cpu"], out[cuda]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for a, b in zip(gg, gc):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())
    params = list(m.parameters())
    cfg = tb.BaselineTrainConfig(model=model)
    loss_fn = tb.baseline_loss(m, model.startswith("pos_"))
    p = pairs.to(cuda)
    tg.train_step(params, adamw_init(params), loss_fn,
                  tg.window_batch(data, p, 5, with_pos=True), cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tg.train_step(params, adamw_init(params), loss_fn,
                      tg.window_batch(data, p, 5, with_pos=True), cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_gru_marl_on_the_card(cuda, tmp_path):
    """run_marl(algo="iql", net="gru") on the card: one stride of 2 tiny
    envs with host synchronisation forbidden in the episode, K1 once a step
    and no overflow, the hidden states in replay; the greedy evaluation
    from the checkpoint restores the agent bit for bit; the served policy
    launches K1 once a step."""
    import dataclasses

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.serving import make_policy_fn
    from swarm_ode_tpu_torch.train import run_rl

    tiny = "tarware-tiny-3agvs-2pickers-partialobs-v1"
    cfg = run_rl.RLRunConfig(env_id=tiny, algo="iql", net="gru", num_envs=2, num_episodes=2,
                             hidden_dim=16, batch_size=16, buffer_size=2000,
                             checkpoint_dir=str(tmp_path), checkpoint_every=2,
                             forbid_host_sync=True)
    bfs_bitpack.LAUNCHES = 0
    out = run_rl.run_marl(cfg, verbose=False)
    h = out["history"][0]
    assert bfs_bitpack.LAUNCHES == 500 and h["replan_overflow"] == 0 and h["loss"] != 0.0
    assert out["buffer"].storage["next_extras"][0][:1000].abs().max() > 0
    ev = run_rl.run_marl(run_rl.RLRunConfig(env_id=tiny, algo="iql", net="gru", num_envs=2,
                                            num_episodes=0, hidden_dim=16, eval_episodes=2,
                                            resume_from=str(tmp_path)), verbose=False)
    for k, v in out["agent_state"].params.items():
        assert torch.equal(ev["agent_state"].params[k], v), k
    pp = run_rl.MarlRun(dataclasses.replace(cfg, checkpoint_dir=None, buffer_size=8)).params
    net = run_rl.make_network(cfg, pp.num_actions, 1.0 / max(pp.grid_h, pp.grid_w)).to(cuda)
    policy = make_policy_fn(pp, net, run_rl.agent_params(out["agent_state"]))
    g = torch.Generator(device=cuda).manual_seed(0)
    s = step_mod.reset(pp, 2, g)
    bfs_bitpack.LAUNCHES = 0
    for _ in range(20):
        s = step_mod.step(pp, s, policy(observe(pp, s)), generator=g)[0]
    assert bfs_bitpack.LAUNCHES == 20


@pytest.mark.cuda
def test_k4_op_equals_the_direct_launch(cuda):
    """K4 through the custom op swarm_ode_tpu_torch::segment_sum_planned
    (the path an exported GDE takes) equals the direct launch bit for bit,
    one counted launch a call; an op call it cannot launch raises."""
    g = torch.Generator().manual_seed(11)
    R, E, N, D = 700, 5000, 300, 64
    x = torch.randn(R, D, generator=g).to(cuda)
    src = torch.randint(0, R, (E,), generator=g).int().to(cuda)
    dst = torch.randint(-5, N + 5, (E,), generator=g).int().to(cuda)
    row, offsets = segment_pallas.segment_plan(dst, None, N, rows=src, num_rows=R)
    for mean in (False, True):
        before = segment_pallas.LAUNCHES
        op = torch.ops.swarm_ode_tpu_torch.segment_sum_planned(x, row, offsets, mean)
        direct = segment_pallas._launch(x, row, offsets, mean)
        torch.cuda.synchronize()
        assert segment_pallas.LAUNCHES == before + 2
        assert torch.equal(op, direct)
    with pytest.raises(ValueError, match="one device"):
        torch.ops.swarm_ode_tpu_torch.segment_sum_planned(x, row, offsets.cpu(), True)


@pytest.mark.cuda
def test_gde_artifact_on_the_card_equals_the_eager_predictor(cuda):
    """A GDE predictor exported on the card and loaded on the card gives the
    eager predictor's bits, through K4 (3 launches an ODE step)."""
    from swarm_ode_tpu_torch import serving
    from swarm_ode_tpu_torch.models.gde import GraphODE

    W, N, D, B, H = 4, 5, 9, 3, 3
    g = torch.Generator().manual_seed(12)
    model = GraphODE(D, 3, 2, 8).init_(g).to(cuda)
    predict = serving.make_gde_fn(model, horizon=H)
    obs = (torch.rand(B, W, N, D, generator=g) * 8.0).to(cuda)
    count = torch.tensor([4, 2, 1], dtype=torch.int32, device=cuda)
    loaded = serving.load_gde(serving.export_gde(predict, W, N, D, batch=B))
    before = segment_pallas.LAUNCHES
    got = loaded(obs, count)
    torch.cuda.synchronize()
    assert segment_pallas.LAUNCHES == before + 3 * H
    assert got.shape == (B, H + 1, N, 2) and torch.equal(got, predict(obs, count))


@pytest.mark.cuda
def test_cpu_exported_policy_serves_on_the_card(cuda):
    """A policy artifact exported on the CPU, loaded with device="cuda",
    gives the CPU policy's actions (greedy, through the claim auction)."""
    from swarm_ode_tpu_torch import serving
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout
    from swarm_ode_tpu_torch.train.run_rl import RLRunConfig, make_network

    cfg = EnvConfig.from_env_id("tarware-tiny-3agvs-2pickers-partialobs-v1")
    lay = build_layout(cfg)
    pp = make_params(cfg, lay, "cpu")
    torch.manual_seed(0)
    net = make_network(RLRunConfig(net="gnn", hidden_dim=16), pp.num_actions,
                       1.0 / max(pp.grid_h, pp.grid_w))
    policy = serving.make_policy_fn(pp, net, coordinated=True)
    obs = observe(pp, heuristic_rollout(pp, lay, 4, 20, torch.Generator().manual_seed(3)).state)
    served = serving.load_policy(serving.export_policy(policy, obs), device="cuda")
    got = served(obs.to(cuda))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), policy(obs))


@pytest.mark.cuda
def test_one_nccl_rank_equals_no_group(cuda, tmp_path):
    """train_gde (2 epochs) and run_mappo (mesh_devices=1 against 0) on the
    card inside a process group of one NCCL rank (a file store) equal the
    runs without a group, bit for bit: parameters and history; the mesh
    takes the card cuda:0."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
    from swarm_ode_tpu_torch.parallel.mesh import make_mesh
    from swarm_ode_tpu_torch.rl import ppo
    from swarm_ode_tpu_torch.train import train_gde as tg

    rng = np.random.RandomState(0)
    eps = [rng.randint(0, 9, size=(30, 5, 19)).astype(np.float32) for _ in range(3)]
    ds = TrajectoryDataset(episodes=eps, num_agvs=3, num_pickers=2, seq_len=5)
    gcfg = tg.GDETrainConfig(num_epochs=2, batch_size=8, hidden_dim=16)
    mcfg = ppo.MAPPOConfig(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1", hidden_dim=8,
                           num_envs=2, num_strides=2, steps_override=16, minibatch=8, seed=1)

    def runs(mesh_devices):
        return (tg.train_gde(ds, gcfg, verbose=False),
                ppo.run_mappo(dataclasses.replace(mcfg, mesh_devices=mesh_devices),
                              verbose=False))

    want = runs(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        assert make_mesh(("dp",)).device == torch.device("cuda", 0)
        got = runs(1)
    finally:
        dist.destroy_process_group()
    assert got[0]["history"] == want[0]["history"]
    assert all(torch.equal(v, want[0]["final_params"][k]) for k, v in got[0]["final_params"].items())
    drop = ("seconds", "collect_seconds", "update_seconds")
    assert ([{k: v for k, v in h.items() if k not in drop} for h in got[1]["history"]]
            == [{k: v for k, v in h.items() if k not in drop} for h in want[1]["history"]])
    assert all(torch.equal(v, want[1]["actor_params"][k]) for k, v in got[1]["actor_params"].items())
