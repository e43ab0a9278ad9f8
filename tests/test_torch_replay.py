"""The port's replay buffer (rl/replay.py) against the JAX package's, bit
for bit: the same items written by add_batch and add (across the ring's
wraparound, episode boundaries and dones), then sample, sample_recent,
sample_nstep and clear with the same indices (JAX's own draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.rl import replay as jr
from swarm_ode_tpu_torch.rl import replay as pr


def _items(rng, t, ep, B, done_p):
    """B lockstep envs' items at env step t of episode ep, nested like
    run_marl's (features, rewards per agent, done, counters)."""
    return {
        "obs_feats": {"agv": rng.randn(B, 3, 7).astype(np.float32),
                      "loc": rng.randn(B, 4, 2).astype(np.float32)},
        "next_feats": {"agv": rng.randn(B, 3, 7).astype(np.float32),
                       "loc": rng.randn(B, 4, 2).astype(np.float32)},
        "actions": rng.randint(0, 9, (B, 5)).astype(np.int32),
        "rewards": rng.randn(B, 5).astype(np.float32),
        "next_global_state": rng.randn(B, 6).astype(np.float32),
        "done": rng.rand(B) < done_p,
        "_t": np.full(B, t, np.int32),
        "_ep": np.full(B, ep, np.int32),
    }


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(want, got, what):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, (what, path, g.dtype, np.asarray(w).dtype)
        assert np.array_equal(g, np.asarray(w)), (what, path)


@pytest.mark.parametrize("B,capacity,n", [(2, 23, 3), (3, 50, 2), (4, 16, 4)])
def test_replay_matches_jax_across_wraparound_and_episodes(B, capacity, n):
    rng = np.random.RandomState(B)
    example = jax.tree.map(lambda a: a[0], _items(rng, 0, 0, B, 0.0))
    jbuf = jr.init(jax.tree.map(jnp.asarray, example), capacity)
    pbuf = pr.init(_torch(example), capacity)
    key = jax.random.PRNGKey(B)
    wrote = 0
    for ep in range(3):
        for t in range(7):
            items = _items(rng, ep * 100 + t, ep, B, 0.15)
            jbuf = jr.add_batch(jbuf, jax.tree.map(jnp.asarray, items))
            pbuf = pr.add_batch(pbuf, _torch(items))
            wrote += B
            assert (pbuf.ptr, pbuf.size) == (int(jbuf.ptr), int(jbuf.size))
            _same(_np(jbuf.storage), pbuf.storage, f"storage after {wrote}")
            for batch in (1, 17):
                key, k1, k2, k3 = jax.random.split(key, 4)
                idx = jax.random.randint(k1, (batch,), 0, jnp.maximum(jbuf.size, 1))
                got = pr.sample_nstep(pbuf, batch, n, B, idx=torch.from_numpy(np.array(idx)))
                _same(_np(jr.sample_nstep(jbuf, k1, batch, n, B)), got, f"nstep after {wrote}")
                got = pr.sample(pbuf, batch, idx=torch.from_numpy(np.array(
                    jax.random.randint(k2, (batch,), 0, jnp.maximum(jbuf.size, 1)))))
                _same(_np(jr.sample(jbuf, k2, batch)), got, f"sample after {wrote}")
                w = jnp.minimum(jnp.int32(2 * B), jbuf.size)
                off = jax.random.randint(k3, (batch,), 1, jnp.maximum(w, 1) + 1)
                got = pr.sample_recent(pbuf, batch, 2 * B, off=torch.from_numpy(np.array(off)))
                _same(_np(jr.sample_recent(jbuf, k3, batch, 2 * B)), got, f"recent {wrote}")
    assert wrote > capacity  # the ring wrapped
    one = jax.tree.map(lambda a: a[0], _items(rng, 999, 9, B, 0.5))
    jbuf, pbuf = jr.add(jbuf, jax.tree.map(jnp.asarray, one)), pr.add(pbuf, _torch(one))
    assert (pbuf.ptr, pbuf.size) == (int(jbuf.ptr), int(jbuf.size))
    _same(_np(jbuf.storage), pbuf.storage, "after add")
    jbuf, pbuf = jr.clear(jbuf), pr.clear(pbuf)
    assert (pbuf.ptr, pbuf.size) == (int(jbuf.ptr), int(jbuf.size)) == (0, 0)


def test_nstep_chains_stop_at_dones_and_episode_ends():
    """The port alone, on the hand-built chains of test_nstep_replay: links
    never cross an episode or a done, and the bootstrap comes from the
    chain's end."""
    B, n = 2, 3
    rng = np.random.RandomState(0)
    ex = jax.tree.map(lambda a: a[0], _items(rng, 0, 0, B, 0.0))
    buf = pr.init(_torch(ex), 64)
    for t in range(7):
        items = _items(rng, t, 0 if t < 5 else 1, B, 0.0)
        items["done"][0] = t == 3
        items["rewards"][:] = np.array([[t], [10 + t]], np.float32)
        items["next_global_state"][:] = t
        buf = pr.add_batch(buf, _torch(items))
    out = pr.sample_nstep(buf, buf.size, n, B, idx=torch.arange(buf.size))
    t0, m, valid = out["_t"].numpy(), out["nstep_m"].numpy(), out["nstep_valid"].numpy()
    for s in range(buf.size):
        hi = 5 if t0[s] < 5 else 7
        assert t0[s] + m[s] - 1 < hi
        assert out["next_global_state"][s, 0] == t0[s] + m[s] - 1
        if s % 2 == 0 and t0[s] <= 3 <= t0[s] + m[s] - 1:
            assert t0[s] + m[s] - 1 == 3 and bool(out["done"][s])
    assert valid[:, 0].all() and (m >= 1).all() and (m <= n).all()
    assert pr.init(_torch(ex), 100).nbytes() == 100 * sum(
        np.asarray(a).nbytes for a in jax.tree.leaves(ex))
