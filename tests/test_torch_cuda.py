"""The CUDA kernels against their plain PyTorch version, on the card.

Needs an NVIDIA GPU; skips without one. It imports neither jax nor the JAX
package, so it also runs where only the port's dependencies are installed:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas


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
