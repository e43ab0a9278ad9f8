"""Export and the committed artifacts: the port's torch.export artifacts
against the JAX package's StableHLO blobs (swarm_ode_tpu/serving.py), the
committed blobs' weights (swarm_ode_tpu_torch/weights/*.npz) against the
blobs themselves, and K4's custom op (ops/segment_pallas.py).

Actions are held bit for bit; GDE predictions within 1e-5 of the largest
prediction (float32 sums in another order than XLA's)."""
import hashlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export

from swarm_ode_tpu import serving as jserving
from swarm_ode_tpu.env import observations as jobs
from swarm_ode_tpu.env import step as jstep
from swarm_ode_tpu.graphs.hetero import hetero_graph_from_obs as jhetero_graph_from_obs
from swarm_ode_tpu.graphs.temporal import TemporalWindow, build_temporal_graph
from swarm_ode_tpu.models.gde import GraphODE as JGraphODE
from swarm_ode_tpu.train.run_rl import RLRunConfig as JRLRunConfig, _make_network
from swarm_ode_tpu_torch import convert, serving
from swarm_ode_tpu_torch.env import step as pstep
from swarm_ode_tpu_torch.env.observations import observe
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.ops import segment_pallas
from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout
from swarm_ode_tpu_torch.train.run_rl import RLRunConfig, make_network
from torch_port_helpers import COMMITTED_BLOBS, REPO, TINY, blob_weights, both, served_windows

POLICIES = [n for n in COMMITTED_BLOBS if n.startswith("policy")]


def _blob(name):
    return (REPO / "results_data" / f"{name}.stablehlo").read_bytes()


def _observations(pp, lay, seed=3):
    """8 observations of a seeded heuristic rollout: 4 envs after 10 and
    after 40 steps."""
    g = torch.Generator().manual_seed(seed)
    first = heuristic_rollout(pp, lay, 4, 10, g).state
    later = heuristic_rollout(pp, lay, 4, 30, g, state=first).state
    return torch.cat([observe(pp, first), observe(pp, later)])


def _jax_gumbel(seed, shape):
    """The Gumbels a stochastic blob draws from its seed
    (swarm_ode_tpu/rl/coordination.py:141)."""
    return np.asarray(jax.jit(lambda s: jax.random.gumbel(jax.random.PRNGKey(s), shape))(
        jnp.uint32(seed)))


def _committed_policy(name, params=None):
    meta, sd = convert.committed_params(name, device="cpu")
    _, _, pp, lay = both(meta["env_id"])
    net = make_network(RLRunConfig(net=meta["net"], hidden_dim=meta["hidden_dim"]),
                       pp.num_actions, 1.0 / max(pp.grid_h, pp.grid_w))
    return meta, pp, lay, serving.make_policy_fn(pp, net, params or sd, meta["coordinated"],
                                                 meta["temperature"])


@pytest.mark.parametrize("name", COMMITTED_BLOBS)
def test_committed_weights_equal_the_blobs(name):
    """Each weights/<name>.npz is, bit for bit, a fresh read of its blob's
    constants (torch_port_helpers.blob_weights), meta included."""
    leaves, meta = blob_weights(name)
    with np.load(REPO / "swarm_ode_tpu_torch" / "weights" / f"{name}.npz") as f:
        assert json.loads(str(f["meta"])) == meta
        assert set(f.files) == set(leaves) | {"meta"}
        for k, a in leaves.items():
            assert f[k].dtype == a.dtype and np.array_equal(f[k], a), k
    assert meta["sha256"] == hashlib.sha256(_blob(name)).hexdigest()


@pytest.mark.parametrize("name", POLICIES)
def test_committed_policy_acts_as_its_blob(name):
    """The port's network with the committed weights, served by
    make_policy_fn on the CPU, gives exactly the blob's actions on 8 seeded
    observations of its env; the clones (T = 3.0) given the Gumbels the
    blob draws from each seed."""
    meta, pp, lay, policy = _committed_policy(name)
    exported = jax_export.deserialize(_blob(name))
    obs = _observations(pp, lay)
    stochastic = meta["temperature"] > 0
    assert len(exported.in_avals) == 1 + stochastic
    acted = 0
    for k in range(obs.shape[0]):
        o = jnp.asarray(obs[k].numpy())
        if stochastic:
            want = np.asarray(exported.call(o, jnp.uint32(k)))
            gumbel = torch.from_numpy(_jax_gumbel(k, (pp.num_agents, pp.num_actions)).copy())
            got = policy(obs[k], gumbel)
        else:
            want = np.asarray(exported.call(o))
            got = policy(obs[k])
        np.testing.assert_array_equal(got.numpy(), want)
        acted += int((want > 0).sum())
    assert acted > 0


@pytest.mark.parametrize("name", POLICIES)
def test_zeroed_leaves_change_no_action(name):
    """The leaves the blob lacks (the last conv block's location-bound
    relations, which feed no Q head) are zeros in the .npz: random values
    there give the same actions."""
    meta, sd = convert.committed_params(name, device="cpu")
    assert len(meta["zeroed"]) == 6 and all("conv1" in k and k.split("/")[-3] in (
        "agv_targets_loc", "pick_manages_loc") for k in meta["zeroed"])
    g = torch.Generator().manual_seed(5)
    moved = dict(sd)
    for k in meta["zeroed"]:
        name_sd = ".".join(p for p in k.split("/") if p != "params")
        name_sd = name_sd[:-len("kernel")] + "weight" if name_sd.endswith("kernel") else name_sd
        assert bool((sd[name_sd] == 0).all())
        moved[name_sd] = torch.randn(sd[name_sd].shape, generator=g)
    _, pp, lay, policy = _committed_policy(name)
    _, _, _, other = _committed_policy(name, moved)
    obs = _observations(pp, lay, seed=4)
    gumbel = torch.from_numpy(_jax_gumbel(0, (obs.shape[0], pp.num_agents, pp.num_actions)).copy())
    args = (gumbel,) if meta["temperature"] > 0 else ()
    assert torch.equal(policy(obs, *args), other(obs, *args))


@pytest.fixture(scope="module")
def tiny():
    """tests/test_serving.py's setup: tiny, gnn at hidden 16, JAX's init
    carried into the port's network; 5 observations of one env, 3 steps of
    the dispatcher apart."""
    jp, _, pp, lay = both(TINY)
    net = _make_network(JRLRunConfig(net="gnn", hidden_dim=16), jp.num_actions, jp.num_agvs,
                        jp.num_pickers, coord_scale=1.0 / float(max(jp.grid_h, jp.grid_w)))
    key = jax.random.PRNGKey(0)
    net_params = jax.jit(lambda k: net.init(k, jhetero_graph_from_obs(
        jp, jobs.observe(jp, jstep.reset(jp, k)))))(key)
    pnet = make_network(RLRunConfig(net="gnn", hidden_dim=16), pp.num_actions,
                        1.0 / max(pp.grid_h, pp.grid_w))
    pnet.load_state_dict(convert.flax_params_to_state_dict(
        jax.tree.map(np.asarray, net_params), device="cpu"))
    g = torch.Generator().manual_seed(1)
    state, obs = pstep.reset(pp, 1, g), []
    for _ in range(5):
        obs.append(observe(pp, state)[0])
        state = heuristic_rollout(pp, lay, 1, 3, g, state=state).state
    return jp, net, net_params, pp, pnet, torch.stack(obs)


@pytest.mark.parametrize("coordinated,temperature", [(False, 0.0), (True, 0.0), (True, 1.5)])
def test_policy_artifact_roundtrip(tiny, coordinated, temperature):
    """A port artifact exported and loaded on the CPU equals the direct
    policy and the JAX package's blob of the same network (greedy,
    coordinated, sampled with JAX's Gumbels); a sampled artifact called
    without Gumbels raises, as a blob without its seed does."""
    jp, net, net_params, pp, pnet, obs = tiny
    policy = serving.make_policy_fn(pp, pnet, coordinated=coordinated, temperature=temperature)
    stochastic = temperature > 0
    served = serving.load_policy(serving.export_policy(policy, obs[0], stochastic), device="cpu")
    jpolicy = jserving.make_policy_fn(jp, net, net_params, coordinated, temperature)
    jserved = jserving.load_policy(jserving.export_policy(jpolicy, jnp.asarray(obs[0].numpy()),
                                                          stochastic))
    for k in range(obs.shape[0]):
        o = obs[k]
        if stochastic:
            gumbel = torch.from_numpy(_jax_gumbel(k, (pp.num_agents, pp.num_actions)).copy())
            got, direct = served(o, gumbel), policy(o, gumbel)
            want = np.asarray(jserved(o.numpy(), k))
        else:
            got, direct = served(o), policy(o)
            want = np.asarray(jserved(o.numpy()))
        assert got.dtype == torch.int32 and torch.equal(got, direct)
        np.testing.assert_array_equal(got.numpy(), want)
    if stochastic:
        with pytest.raises(ValueError, match="gumbel"):
            served(obs[0])
    with pytest.raises(ValueError, match="stochastic"):
        serving.export_policy(policy, obs[0], not stochastic)


def test_gde_artifact_roundtrip():
    """tests/test_serving.py:93-118's GDE at (W, N, D, H) = (4, 5, 9, 3),
    JAX's init carried over: the port's artifact equals the direct
    predictor and the JAX blob, including a warm-up (count < W) window."""
    W, N, D, H = 4, 5, 9, 3
    jmodel = JGraphODE(node_dim=D, num_agvs=3, num_pickers=2, hidden_dim=8)
    obs = np.random.RandomState(0).rand(W, N, D).astype(np.float32) * 8.0
    params = jax.jit(lambda k, o: jmodel.init(k, build_temporal_graph(
        TemporalWindow(obs=o, count=jnp.int32(W)), 3, 5.0), jnp.array([0.0, 1.0])))(
        jax.random.PRNGKey(0), jnp.asarray(obs))
    jblob = jserving.load_gde(jserving.export_gde(jserving.make_gde_fn(jmodel, params, horizon=H),
                                                  window=W, num_agents=N, obs_dim=D))
    predict = serving.make_gde_fn(
        GraphODE(D, 3, 2, 8), convert.gde_params_from_numpy(jax.tree.map(np.asarray, params),
                                                            device="cpu"), horizon=H)
    served = serving.load_gde(serving.export_gde(predict, W, N, D), device="cpu")
    for count in (W, 2):
        c = torch.tensor(count, dtype=torch.int32)
        got = served(torch.from_numpy(obs), c)
        assert got.shape == (H + 1, N, 2)
        assert torch.equal(got, predict(torch.from_numpy(obs), c))
        want = np.asarray(jblob(obs, count))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_committed_gde_artifact_matches_its_blob():
    """The flagship GDE with its committed weights, exported for batches of
    3 windows and loaded on the CPU, against the blob on the port's own
    medium windows, within 1e-5 of the largest prediction; the op is K4's
    custom op in the exported graph."""
    meta, sd = convert.committed_params("gde_medium_h4w", device="cpu")
    w = served_windows()
    model = GraphODE(meta["obs_dim"], 19, 9, meta["hidden_dim"], "euler")
    predict = serving.make_gde_fn(model, sd, horizon=meta["horizon"])
    blob = serving.export_gde(predict, meta["window"], meta["num_agents"], meta["obs_dim"], batch=3)
    program = torch.export.load(io.BytesIO(blob))
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    op = torch.ops.swarm_ode_tpu_torch.segment_sum_planned.default
    assert ops.count(op) == 3 * meta["horizon"]
    got = serving.load_gde(blob, device="cpu")(w.obs, w.count)
    assert torch.equal(got, predict(w.obs, w.count))
    jblob = jserving.load_gde(_blob("gde_medium_h4w"))
    for b in range(3):
        want = np.asarray(jblob(w.obs[b].numpy(), w.count[b].numpy()))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_segment_op_fake_gives_the_plain_shape_and_dtype():
    """The op's fake gives what its CPU kernel (the plain version) gives,
    without reading the plan."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(2)
    data = torch.randn(30, 7, generator=g)
    ids = torch.randint(-2, 12, (50,), generator=g).int()
    row, offsets = segment_pallas.segment_plan(ids, None, 10, rows=ids.abs() % 30, num_rows=30)
    for mean in (False, True):
        ref = segment_pallas.segment_sum_planned_plain(data, row, offsets, mean)
        got = segment_pallas.segment_sum_planned(data, row, offsets, mean)
        assert torch.equal(got, ref)
        with FakeTensorMode() as mode:
            fake = torch.ops.swarm_ode_tpu_torch.segment_sum_planned(
                mode.from_tensor(data), mode.from_tensor(row), mode.from_tensor(offsets), mean)
        assert fake.shape == ref.shape and fake.dtype == ref.dtype == torch.float32
    torch.library.opcheck(torch.ops.swarm_ode_tpu_torch.segment_sum_planned.default,
                          (data, row, offsets, True), test_utils=("test_schema", "test_faketensor"))


def test_serve_cli_runs_a_tiny_episode(tiny, tmp_path, capsys):
    """The serving CLI (python -m swarm_ode_tpu_torch.serving) with --cpu
    drives one tiny episode from an artifact file and prints the stat
    line."""
    _, _, _, pp, pnet, obs = tiny
    path = tmp_path / "policy.pt2"
    path.write_bytes(serving.export_policy(serving.make_policy_fn(pp, pnet, coordinated=True),
                                           obs[0]))
    serving.main(["--blob", str(path), "--env_id", TINY, "--num_episodes", "1", "--cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("Episode 0: | [Overall Pick Rate=") and "[Total clashes=" in line
