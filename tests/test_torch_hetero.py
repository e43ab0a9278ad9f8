"""The port's hetero graph (graphs/hetero.py) and busy flags
(rl/coordination.busy_from_feats) against the JAX package's, bit for bit:
on the observations of JAX's own tiny and medium heuristic rollouts, and on
features with coordinates drawn outside the grid (JAX clamps those gather
indices; the port must too)."""
import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.graphs import hetero as jh
from swarm_ode_tpu.rl import coordination as jcoord
from swarm_ode_tpu_torch.graphs import hetero as ph
from swarm_ode_tpu_torch.rl import coordination as pcoord
from torch_port_helpers import MEDIUM, TINY, assert_same, both, jax_observations


def _jax_fns(jp):
    def one(obs):
        a, p, l = jh.split_observation(jp, obs)
        g = jh.build_hetero_graph(jp, a, p, l)
        return (a, p, l, g, jh.masks_from_feats(jp, a, p, l),
                jcoord.busy_from_feats(a, p), jh.hetero_graph_from_obs(jp, obs))

    def from_feats(a, p, l):
        return (jh.build_hetero_graph(jp, a, p, l), jh.masks_from_feats(jp, a, p, l),
                jcoord.busy_from_feats(a, p))

    return jax.jit(jax.vmap(one)), jax.jit(jax.vmap(from_feats))


def _graph_dict(g):
    return {k: np.asarray(getattr(g, k)) for k in (
        "agv_x", "picker_x", "loc_x", "agv2loc", "loc2agv", "agv2agv", "pick2loc",
        "agv2pick", "pick2agv")}


def _port(pp, a, p, l):
    g = ph.build_hetero_graph(pp, a, p, l)
    return g, ph.masks_from_feats(pp, a, p, l), pcoord.busy_from_feats(a, p)


@pytest.mark.parametrize("env_id,B,T", [(TINY, 4, 60), (MEDIUM, 3, 40)])
def test_hetero_graph_matches_jax_on_rollouts(env_id, B, T):
    jp, jl, pp, _ = both(env_id)
    one, _ = _jax_fns(jp)
    observations = jax_observations(jp, jl, B, T, seed=5, every=4)
    edges = 0
    for k, obs in enumerate(observations):
        a, p, l, g, masks, busy, g2 = one(obs)
        pobs = torch.from_numpy(obs)
        pa, pp_, pl = ph.split_observation(pp, pobs)
        assert_same({"agv": np.asarray(a), "picker": np.asarray(p), "loc": np.asarray(l)},
                    {"agv": pa.numpy(), "picker": pp_.numpy(), "loc": pl.numpy()},
                    f"split {k}")
        pg, pmasks, pbusy = _port(pp, pa, pp_, pl)
        assert_same(_graph_dict(g), {k2: v.numpy() for k2, v in vars(pg).items()}, f"graph {k}")
        assert_same(_graph_dict(g2), {k2: v.numpy() for k2, v in
                                      vars(ph.hetero_graph_from_obs(pp, pobs)).items()},
                    f"graph from obs {k}")
        assert_same({"masks": np.asarray(masks), "busy": np.asarray(busy)},
                    {"masks": pmasks.numpy(), "busy": pbusy.numpy()}, f"masks {k}")
        edges += int(np.asarray(g.agv2pick).sum() + np.asarray(g.pick2loc).sum())
    assert edges > 0


@pytest.mark.parametrize("env_id", [TINY, MEDIUM])
def test_hetero_graph_clamps_out_of_range_coordinates_as_jax(env_id):
    """Features whose coordinates lie off the grid (negative, past the last
    row or column, fractional): the cell_to_rack gathers follow JAX's
    index rule, and the dropped scatters drop."""
    jp, jl, pp, _ = both(env_id)
    _, from_feats = _jax_fns(jp)
    obs = jax_observations(jp, jl, 4, 12, seed=9, every=12)[-1]
    a, p, l = (np.array(x) for x in jax.vmap(lambda o: jh.split_observation(jp, o))(obs))
    rng = np.random.RandomState(0)
    H, W = jp.grid_h, jp.grid_w
    for f, cols in ((a, [3, 4, 5, 6]), (p, [0, 1, 2, 3])):
        for c in cols:
            lim = H if c % 2 == (1 if f is a else 0) else W
            f[..., c] = rng.randint(-2 * lim - 3, 2 * lim + 3, f[..., c].shape)
        f[..., cols[0]] += rng.choice([0.0, 0.4, -0.6], f[..., cols[0]].shape)
    a[..., 0] = rng.rand(*a[..., 0].shape) < 0.5  # carrying
    a[..., 2] = rng.rand(*a[..., 2].shape) < 0.5  # toggling
    g, masks, busy = from_feats(a, p, l)
    pg, pmasks, pbusy = _port(pp, *(torch.from_numpy(x) for x in (a, p, l)))
    assert_same(_graph_dict(g), {k: v.numpy() for k, v in vars(pg).items()}, "graph")
    assert_same({"masks": np.asarray(masks), "busy": np.asarray(busy)},
                {"masks": pmasks.numpy(), "busy": pbusy.numpy()}, "masks")
