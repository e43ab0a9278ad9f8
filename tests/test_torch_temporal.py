"""The port's temporal graphs and SAGE aggregation against the JAX package.

Windows, positions, edges and masks are compared bit for bit (positions are
small integers, or floats whose squared distances both packages compute in
the same order); mean aggregations at the JAX package's HIGHEST precision
within 1e-5 (float32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.graphs import temporal as jt
from swarm_ode_tpu.ops.sage import HomoSAGE as JHomoSAGE
from swarm_ode_tpu.ops.sage import TemporalSAGE as JTemporalSAGE
from swarm_ode_tpu.ops.sage import masked_mean_aggregate as jmasked_mean
from swarm_ode_tpu.ops.sage import temporal_mean_aggregate as jtemporal_mean
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.graphs import temporal as pt
from swarm_ode_tpu_torch.ops import sage

HIGHEST = jax.lax.Precision.HIGHEST
W, N, D, NUM_AGVS = 4, 6, 9, 4


def _windows(seed, integer_positions=True):
    """W + 1 windows with counts 0..W, invalid frames zeroed."""
    rng = np.random.RandomState(seed)
    B = W + 1
    obs = rng.rand(B, W, N, D).astype(np.float32) * 8.0
    if integer_positions:
        obs[..., :5] = rng.randint(0, 9, (B, W, N, 5))
    count = np.arange(B, dtype=np.int32)
    obs *= (np.arange(W)[None, :] < count[:, None])[:, :, None, None]
    return obs, count


def test_push_frame_matches_jax():
    B = 3
    rng = np.random.RandomState(0)
    jw = jax.vmap(lambda _: jt.init_window(W, N, D))(jnp.arange(B))
    pw = pt.init_window(B, W, N, D, device="cpu")
    push = jax.jit(jax.vmap(jt.push_frame))
    for k in range(W + 3):
        frame = rng.rand(B, N, D).astype(np.float32)
        jw = push(jw, jnp.asarray(frame))
        pw = pt.push_frame(pw, torch.from_numpy(frame))
        np.testing.assert_array_equal(pw.obs.numpy(), np.asarray(jw.obs))
        np.testing.assert_array_equal(pw.count.numpy(), np.asarray(jw.count))
        assert pw.count.dtype == torch.int32


@pytest.mark.parametrize("integer_positions", [True, False])
def test_graphs_match_jax(integer_positions):
    obs, count = _windows(1, integer_positions)
    threshold = 5.0 if integer_positions else 2.5
    jg = jax.vmap(lambda o, c: jt.build_temporal_graph(jt.TemporalWindow(o, c), NUM_AGVS, threshold))(
        jnp.asarray(obs), jnp.asarray(count))
    jb = jt.build_temporal_batch(jnp.asarray(obs), jnp.asarray(count), NUM_AGVS, threshold)
    po, pc = torch.from_numpy(obs), torch.from_numpy(count)
    pg = pt.build_temporal_graph(pt.TemporalWindow(po, pc), NUM_AGVS, threshold)
    pb = pt.build_temporal_batch(po, pc, NUM_AGVS, threshold)
    for name in ("x", "adj", "node_mask", "is_current"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(), np.asarray(getattr(jg, name)), name)
    for name in ("x", "spatial", "frame_valid", "count"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)), name)
    np.testing.assert_array_equal(
        pt.extract_positions(po, NUM_AGVS).numpy(),
        np.asarray(jax.vmap(jax.vmap(lambda o: jt.extract_positions(o, NUM_AGVS)))(jnp.asarray(obs))),
    )
    # Spatial edges and temporal links both occur.
    assert pb.spatial.any() and (pg.adj.sum() > pb.spatial.sum())


def test_aggregations_match_jax():
    obs, count = _windows(2)
    jb = jt.build_temporal_batch(jnp.asarray(obs), jnp.asarray(count), NUM_AGVS)
    pb = pt.build_temporal_batch(torch.from_numpy(obs), torch.from_numpy(count), NUM_AGVS)
    ref = np.asarray(jtemporal_mean(jb.x, jb.spatial, jb.frame_valid, precision=HIGHEST))
    got = sage.temporal_mean_aggregate(pb.x, pb.spatial, pb.frame_valid)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # The edge-list form (K4's path) agrees with the structured one.
    sparse = sage.edge_mean_aggregate(pb.x, pt.temporal_edges(pb))
    np.testing.assert_allclose(sparse.numpy(), ref, rtol=0, atol=1e-5)
    # And the dense form, per window.
    pg = pt.build_temporal_graph(pt.TemporalWindow(pb.x, pb.count), NUM_AGVS)
    jg = jax.vmap(lambda o, c: jt.build_temporal_graph(jt.TemporalWindow(o, c), NUM_AGVS))(
        jnp.asarray(obs), jnp.asarray(count))
    jdense = jax.vmap(lambda x, a, m: jmasked_mean(x, a, m, precision=HIGHEST))(
        jg.x, jg.adj, jg.node_mask)
    dense = sage.masked_mean_aggregate(pg.x, pg.adj, pg.node_mask)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dense.numpy().reshape(ref.shape), ref, rtol=0, atol=1e-5)


def test_temporal_edges_cover_the_dense_graph():
    """The batch's edge list is each window's dense adjacency in row-major
    order, offset by window, and its capacity is never exceeded."""
    obs, count = _windows(3)
    obs[..., :5] = 0.0  # every agent on one cell: the densest graph
    pb = pt.build_temporal_batch(torch.from_numpy(obs), torch.from_numpy(count), NUM_AGVS)
    src, dst, valid = pt.temporal_edges(pb)
    adj = pt.dense_adjacency(pb)
    B = obs.shape[0]
    cap = pt.edge_capacity(W, N)
    assert src.shape == (B * cap,) and src.dtype == torch.int32
    assert int(valid.sum()) == int(adj.sum())
    assert int(valid.view(B, cap)[-1].sum()) == cap  # the full window fills it
    for b in range(B):
        v = valid.view(B, cap)[b]
        s = src.view(B, cap)[b][v] - b * W * N
        d = dst.view(B, cap)[b][v] - b * W * N
        ref = adj[b].nonzero()
        assert torch.equal(s.long(), ref[:, 0]) and torch.equal(d.long(), ref[:, 1])


def test_sage_modules_match_jax():
    """HomoSAGE on the dense graphs and TemporalSAGE on the structured ones,
    with the same flax parameters converted: 1e-5 (unit-scale weights,
    features up to 8)."""
    obs, count = _windows(4)
    jb = jt.build_temporal_batch(jnp.asarray(obs), jnp.asarray(count), NUM_AGVS)
    jg = jax.vmap(lambda o, c: jt.build_temporal_graph(jt.TemporalWindow(o, c), NUM_AGVS))(
        jnp.asarray(obs), jnp.asarray(count))
    jtemporal = JTemporalSAGE(3)
    p = jtemporal.init(jax.random.PRNGKey(0), jb.x, jb.spatial, jb.frame_valid)
    with jax.default_matmul_precision("highest"):
        ref_t = np.asarray(jtemporal.apply(p, jb.x, jb.spatial, jb.frame_valid))
        ref_h = np.asarray(jax.vmap(lambda x, a, m: JHomoSAGE(3).apply(
            {"params": {"DenseSAGEConv_0": p["params"]}}, x, a, m))(jg.x, jg.adj, jg.node_mask))
    # One flax Dense layout for both: lin_l (kernel, bias), lin_r (kernel).
    sd = convert.gde_params_from_numpy({
        "func": {"params": {"conv": {"DenseSAGEConv_0": jax.tree.map(np.asarray, p["params"])}}},
        "decoder": {"params": {"position_decoder": {"kernel": np.zeros((1, 2)), "bias": np.zeros(2)}}},
    }, device="cpu")
    layer = {k.split("DenseSAGEConv_0.")[1]: v for k, v in sd.items() if "DenseSAGEConv_0" in k}
    temporal_mod, homo = sage.TemporalSAGE(D, 3), sage.HomoSAGE(D, 3)
    temporal_mod.load_state_dict(layer)
    homo.DenseSAGEConv_0.load_state_dict(layer)
    pb = pt.build_temporal_batch(torch.from_numpy(obs), torch.from_numpy(count), NUM_AGVS)
    pg = pt.build_temporal_graph(pt.TemporalWindow(pb.x, pb.count), NUM_AGVS)
    with torch.no_grad():
        got_t = temporal_mod(pb.x, pb.spatial, pb.frame_valid)
        got_h = homo(pg.x, pg.adj, pg.node_mask)
    np.testing.assert_allclose(got_t.numpy(), ref_t, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), ref_h, rtol=0, atol=1e-5)
