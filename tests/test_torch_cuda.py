"""The CUDA kernels against their plain PyTorch version, on the card.

Needs an NVIDIA GPU; skips without one. It imports neither jax nor the JAX
package, so it also runs where only the port's dependencies are installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas, segment_pallas


def _random_rows(H, W, K, seed):
    g = torch.Generator().manual_seed(seed)
    Ws = W + 1
    n = H * Ws
    grid = torch.rand(K, H, W, generator=g) < 0.75
    pas = torch.cat([grid, torch.zeros(K, H, 1, dtype=torch.bool)], 2).reshape(K, n)
    tgt = (torch.randint(0, H, (K,), generator=g) * Ws + torch.randint(0, W, (K,), generator=g)).int()
    pos = (torch.randint(0, H, (K,), generator=g) * Ws + torch.randint(0, W, (K,), generator=g)).int()
    col = torch.arange(n)
    pas |= (col == tgt[:, None]) | (col == pos[:, None])
    return pas, tgt, pos


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
@pytest.mark.parametrize("H,W", [(25, 22), (45, 30), (80, 30)])  # 19, 45 and 79 words
def test_kernels_match_plain(cuda, H, W):
    cpu = _random_rows(H, W, 512, seed=H + W)
    ref = bfs_pallas.query_plain(*cpu, H, W, 40)
    gpu = tuple(t.to(cuda) for t in cpu)
    for call, counter in ((bfs_bitpack.bitpack_query_call, bfs_bitpack),
                          (bfs_pallas.query_call, bfs_pallas)):
        before = counter.LAUNCHES
        d, nd = call(*gpu, H, W, 40)
        torch.cuda.synchronize()
        assert counter.LAUNCHES == before + 1
        assert torch.equal(d.cpu(), ref[0]) and torch.equal(nd.cpu(), ref[1])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take(cuda):
    pas, tgt, pos = (t.to(cuda) for t in _random_rows(9, 8, 16, seed=0))
    with pytest.raises(ValueError, match="int32"):
        bfs_bitpack.bitpack_query_call(pas, tgt.long(), pos, 9, 8, 4)
    with pytest.raises(ValueError, match="contiguous"):
        bfs_pallas.query_call(pas.t().contiguous().t(), tgt, pos, 9, 8, 4)
    with pytest.raises(ValueError, match="pas must be"):
        bfs_pallas.query_call(pas[:, :-1], tgt, pos, 9, 8, 4)


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
    plan = segment_pallas.segment_plan(dst, valid, N, rows=src)
    xg, dg, vg, sg = (t.to(cuda) for t in (x, dst, valid, src))
    torch.cuda.synchronize()
    before = segment_pallas.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        gplan = segment_pallas.segment_plan(dg, vg, N, rows=sg)
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
