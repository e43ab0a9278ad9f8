"""The port's sparse path (ops/segment.py, the plain version of K4 on the
CPU) against the JAX package: segment sums against `segment_sum` and the
Pallas kernel `segment_sum_pallas` in interpret mode (as
tests/test_pallas_kernels.py runs it), edge lists exactly, and the sparse
mean against the dense one. K4's plan (destination order) against numpy,
and the planned sums and the served predictions bit for bit against the
unplanned ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.ops import segment as jseg
from swarm_ode_tpu.ops.sage import masked_mean_aggregate as jmasked_mean
from swarm_ode_tpu.ops.segment_pallas import segment_sum_pallas
from swarm_ode_tpu_torch import serving
from swarm_ode_tpu_torch.models import gde as gde_module
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.ops import segment as pseg
from swarm_ode_tpu_torch.ops import segment_pallas
from swarm_ode_tpu_torch.ops.sage import masked_mean_aggregate
from swarm_ode_tpu_torch.serving import make_gde_fn
from torch_port_helpers import served_windows


def _edges(seed, E=300, D=7, N=23):
    rng = np.random.RandomState(seed)
    data = rng.randn(E, D).astype(np.float32)
    ids = rng.randint(-3, N + 3, E).astype(np.int32)  # some out of range
    valid = rng.rand(E) < 0.8
    return data, ids, valid, N


@pytest.mark.parametrize("masked", [True, False])
def test_segment_sum_matches_jax_and_the_pallas_kernel(masked):
    """Ids below 0 or at N and above are dropped by all three. 1e-5: float32
    sums of about a dozen unit-scale terms in another order."""
    data, ids, valid, N = _edges(0)
    jv = jnp.asarray(valid) if masked else None
    ref = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), N, jv))
    kern = np.asarray(segment_sum_pallas(jnp.asarray(data), jnp.asarray(ids), N, jv,
                                         block_e=128, interpret=True))
    got = pseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), N,
                           torch.from_numpy(valid) if masked else None)
    assert got.shape == (N, data.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=1e-5)


def test_segment_mean_matches_jax():
    data, ids, valid, N = _edges(1)
    ids = np.clip(ids, 0, N - 1)
    ref = np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids), N, jnp.asarray(valid)))
    got = pseg.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), N,
                            torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("capacity", [1, 17, 35, 80])
def test_adjacency_to_edges_matches_jax(capacity):
    """Exact, with fewer slots than edges (dropped), as many, and more
    (padding); the batched form equals one call per adjacency."""
    rng = np.random.RandomState(capacity)
    adj = rng.rand(3, 7, 5) < 0.4
    got = pseg.adjacency_to_edges(torch.from_numpy(adj), capacity)
    for b in range(adj.shape[0]):
        ref = jseg.adjacency_to_edges(jnp.asarray(adj[b]), capacity)
        for name, g, r in zip(("src", "dst", "valid"), got, ref):
            assert g.shape == (3, capacity)
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r), name)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool


def test_gather_scatter_mean_matches_dense():
    """1e-6, as tests/test_graphs_models.py:88 holds the JAX pair."""
    rng = np.random.RandomState(0)
    S, T, D = 7, 5, 3
    adj = rng.rand(S, T) < 0.4
    x = rng.randn(S, D).astype(np.float32)
    dense_jax = np.asarray(jmasked_mean(jnp.asarray(x), jnp.asarray(adj),
                                        precision=jax.lax.Precision.HIGHEST))
    src, dst, valid = pseg.adjacency_to_edges(torch.from_numpy(adj), S * T)
    before = segment_pallas.LAUNCHES
    sparse = pseg.gather_scatter_mean(torch.from_numpy(x), src, dst, valid, T)
    assert segment_pallas.LAUNCHES == before  # CPU tensors: the plain version
    dense = masked_mean_aggregate(torch.from_numpy(x), torch.from_numpy(adj))
    np.testing.assert_allclose(sparse.numpy(), dense_jax, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dense.numpy(), dense_jax, rtol=0, atol=1e-6)
    jsrc, jdst, jvalid = jseg.adjacency_to_edges(jnp.asarray(adj), S * T)
    sparse_jax = np.asarray(jseg.gather_scatter_mean(jnp.asarray(x), jsrc, jdst, jvalid, T))
    np.testing.assert_allclose(sparse.numpy(), sparse_jax, rtol=0, atol=1e-6)


def test_precomputed_in_degree_gives_the_same_mean():
    """The GDE server sums a graph's in-degrees once and passes them to every
    layer's mean: the same division, so exactly the same result."""
    data, ids, valid, N = _edges(2)
    d, i, v = torch.from_numpy(data), torch.from_numpy(ids), torch.from_numpy(valid)
    count = pseg.segment_count(i, N, v)
    assert count.shape == (N, 1)
    in_range = (ids >= 0) & (ids < N) & valid
    np.testing.assert_array_equal(count[:, 0].numpy(), np.bincount(ids[in_range], minlength=N))
    torch.testing.assert_close(pseg.segment_mean(d, i, N, v, count),
                               pseg.segment_mean(d, i, N, v), rtol=0, atol=0)


def _plan_reference(ids, valid, N, rows=None):
    """segment_plan in numpy: a stable sort of the keys, invalid and
    out-of-range ids keyed N; offsets from the cumulative counts."""
    keep = (ids >= 0) & (ids < N) & (True if valid is None else valid)
    key = np.where(keep, ids, N)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key[keep], minlength=N)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return order if rows is None else rows[order], offsets, keep, order


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("gather", [True, False])
def test_segment_plan_matches_numpy(masked, gather):
    """Rows in stable destination order, offsets the cumulative counts, and
    every invalid or out-of-range entry at or beyond offsets[N]."""
    data, ids, valid, N = _edges(3)
    rows = np.random.RandomState(4).randint(0, 50, ids.shape[0]).astype(np.int32)
    v = valid if masked else None
    ref_row, ref_off, keep, order = _plan_reference(ids, v, N, rows if gather else None)
    row, offsets = segment_pallas.segment_plan(
        torch.from_numpy(ids), None if v is None else torch.from_numpy(v), N,
        torch.from_numpy(rows) if gather else None, 50 if gather else None)
    assert row.dtype == offsets.dtype == torch.int32 and offsets.shape == (N + 1,)
    np.testing.assert_array_equal(offsets.numpy(), ref_off)
    np.testing.assert_array_equal(row.numpy(), ref_row)
    assert set(order[ref_off[N]:].tolist()) == set(np.flatnonzero(~keep).tolist())


@pytest.mark.parametrize("mean", [False, True])
def test_planned_plain_sum_equals_the_unplanned_one(mean):
    """Bit for bit (atol 0): the plan keeps each bucket's entries in edge
    order, the order index_add_ sums them in, and the mean divides by the
    same counts. Read through an index (the gather), and without one."""
    data, ids, valid, N = _edges(5)
    d, i, v = torch.from_numpy(data), torch.from_numpy(ids), torch.from_numpy(valid)
    ref = pseg.segment_mean(d, i, N, v) if mean else segment_pallas.segment_sum_plain(d, i, N, v)
    got = segment_pallas.segment_sum_planned(d, *segment_pallas.segment_plan(i, v, N), mean=mean)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    x = torch.from_numpy(np.random.RandomState(6).randn(40, data.shape[1]).astype(np.float32))
    src = torch.from_numpy(np.random.RandomState(7).randint(0, 40, ids.shape[0]).astype(np.int32))
    ref = (pseg.segment_mean(x[src.long()], i, N, v) if mean
           else segment_pallas.segment_sum_plain(x[src.long()], i, N, v))
    got = segment_pallas.segment_sum_planned(
        x, *segment_pallas.segment_plan(i, v, N, rows=src, num_rows=40), mean=mean)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_gather_scatter_mean_with_a_plan_matches_jax():
    """1e-6, as tests/test_graphs_models.py:88 holds the JAX pair; the plan
    passed in gives what the plan built inside gives."""
    rng = np.random.RandomState(8)
    S, T, D = 9, 6, 4
    adj = rng.rand(S, T) < 0.4
    x = rng.randn(S, D).astype(np.float32)
    src, dst, valid = pseg.adjacency_to_edges(torch.from_numpy(adj), 40)
    plan = segment_pallas.segment_plan(dst, valid, T, rows=src, num_rows=S)
    got = pseg.gather_scatter_mean(torch.from_numpy(x), src, dst, valid, T, plan)
    jsrc, jdst, jvalid = jseg.adjacency_to_edges(jnp.asarray(adj), 40)
    ref = np.asarray(jseg.gather_scatter_mean(jnp.asarray(x), jsrc, jdst, jvalid, T))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        got, pseg.gather_scatter_mean(torch.from_numpy(x), src, dst, valid, T), rtol=0, atol=0)


def test_gather_scatter_mean_reads_out_of_range_sources_as_jax_does():
    """JAX's `x_src[src]` adds S once to a negative source, then clamps into
    [0, S): at S = 6, -1 -> 5, -3 -> 3, -7 -> 0, -20 -> 0, 6 -> 5, 9 -> 5.
    The plan normalises its rows the same way, so the mean is bit for bit
    JAX's, the int32 extremes included, and K4 never reads outside x."""
    S, D, T = 6, 5, 4
    rng = np.random.RandomState(9)
    x = rng.randn(S, D).astype(np.float32)
    src = np.concatenate([[-1, -3, -7, -20, 6, 9, 2**31 - 1, -2**31],
                          rng.randint(-3 * S, 3 * S, 32)]).astype(np.int32)
    dst = rng.randint(-2, T + 2, src.size).astype(np.int32)
    valid = rng.rand(src.size) < 0.85
    ref = np.asarray(jseg.gather_scatter_mean(*(jnp.asarray(a) for a in (x, src, dst, valid)), T))
    t = [torch.from_numpy(a) for a in (x, src, dst, valid)]
    np.testing.assert_array_equal(pseg.gather_scatter_mean(*t, T).numpy(), ref)
    row, _ = segment_pallas.segment_plan(torch.from_numpy(np.arange(8, dtype=np.int32) % T), None,
                                         T, rows=t[1][:8], num_rows=S)
    np.testing.assert_array_equal(np.sort(row.numpy()), np.sort([5, 3, 0, 0, 5, 5, 5, 0]))


def test_segment_plan_takes_rows_with_their_count():
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        segment_pallas.segment_plan(ids, None, 2, rows=ids)
    with pytest.raises(ValueError, match="together"):
        segment_pallas.segment_plan(ids, None, 2, num_rows=4)
    with pytest.raises(ValueError, match="at least 1"):
        segment_pallas.segment_plan(ids, None, 2, rows=ids, num_rows=0)


def test_served_predictions_through_the_plan(monkeypatch):
    """The server on seeded medium windows (D = 435, 28 agents) aggregates
    through one plan per batch. On the CPU that is bit for bit the unplanned
    aggregation (gather x[src], then segment_mean), and within
    tests/test_torch_gde.py's tolerance (rtol 1e-4, atol 1e-5) of the
    structured path."""
    w = served_windows()
    torch.manual_seed(0)
    model = GraphODE(435, 19, 9, 16, "euler")
    predict = make_gde_fn(model, None, 5.0, 4)
    planned = predict(w.obs, w.count)

    def unplanned(x, edges, plan=None):
        src, dst, valid = edges
        B, W, N, D = x.shape
        msgs = x.reshape(B * W * N, D)[src.long()]
        return pseg.segment_mean(msgs, dst, B * W * N, valid).view(B, W, N, D)

    with monkeypatch.context() as m:
        m.setattr(gde_module, "edge_mean_aggregate", unplanned)
        ref = predict(w.obs, w.count)
    with monkeypatch.context() as m:
        m.setattr(serving, "temporal_edges", lambda g: None)  # the structured path
        structured = predict(w.obs, w.count)
    assert planned.shape == (3, 5, 28, 2) and bool(torch.isfinite(planned).all())
    torch.testing.assert_close(planned, ref, rtol=0, atol=0)
    np.testing.assert_allclose(planned.numpy(), structured.numpy(), rtol=1e-4, atol=1e-5)
    assert (planned[:, 1:] - planned[:, :1]).abs().max() > 1e-3
