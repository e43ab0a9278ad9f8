"""Shared helpers of the tests that hold swarm_ode_tpu_torch against the JAX
package: JAX structs to numpy dicts, the JAX step's and the stochastic
dispatcher's random draws, field-by-field comparison, medium windows of
observations to serve, and the committed serving blobs' weights read out of
the blobs (blob_weights; write_committed_weights writes the port's copies)."""
from __future__ import annotations

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from swarm_ode_tpu.config import EnvConfig as JEnvConfig
from swarm_ode_tpu.env import step as jstep
from swarm_ode_tpu.env.layout import build_layout as jbuild_layout
from swarm_ode_tpu.env.state import make_params as jmake_params
from swarm_ode_tpu.policies import heuristic as jheur
from swarm_ode_tpu_torch.config import EnvConfig as PEnvConfig
from swarm_ode_tpu_torch.env.layout import build_layout as pbuild_layout
from swarm_ode_tpu_torch.env.observations import observe
from swarm_ode_tpu_torch.env.state import make_params as pmake_params
from swarm_ode_tpu_torch.env.step import StepNoise
from swarm_ode_tpu_torch.graphs import temporal as pt
from swarm_ode_tpu_torch.policies.heuristic import DispatchNoise, heuristic_rollout

TINY = "tarware-tiny-3agvs-2pickers-partialobs-v1"
MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"

# Tiny tensors: keep torch's intra-op threads from oversubscribing the
# test workers.
torch.set_num_threads(2)


def fields(obj) -> dict:
    """A flax struct (or any dataclass) as a dict of numpy arrays."""
    return {
        f.name: np.asarray(getattr(obj, f.name))
        for f in dataclasses.fields(obj)
        if not isinstance(getattr(obj, f.name), (int, float, str, bool))
    }


def both(env_id: str, **overrides):
    """(JAX params, JAX layout, port params, port layout) for one config."""
    jcfg = JEnvConfig.from_env_id(env_id, **overrides)
    pcfg = PEnvConfig.from_env_id(env_id, **overrides)
    jlay = jbuild_layout(jcfg)
    play = pbuild_layout(pcfg)
    return jmake_params(jcfg, jlay), jlay, pmake_params(pcfg, play, "cpu"), play


@functools.lru_cache(maxsize=None)
def _noise_fn(A: int, G: int, S: int, deadlock_break: bool):
    """Per env: the draws the JAX step makes from `key`, and the key it
    leaves in the next state (env/step.py:384-386, :603-611)."""

    def one(key):
        r = jnp.zeros(A, jnp.int32)
        if deadlock_break:
            kb, key = jax.random.split(key)
            r = jax.random.randint(kb, (A,), 0, 4)
        gs = []
        for _ in range(G):
            key, sub = jax.random.split(key)
            gs.append(jax.random.gumbel(sub, (S,)))
        return r, jnp.stack(gs), key

    return jax.jit(jax.vmap(one))


def jax_noise(jparams, keys):
    """(StepNoise for the port, next keys) from a batch of JAX state keys."""
    r, g, nxt = _noise_fn(
        jparams.num_agents, jparams.num_goals, jparams.num_shelves,
        bool(jparams.deadlock_break),
    )(keys)
    noise = StepNoise(
        break_r=torch.from_numpy(np.array(r)).to(torch.int32),
        delivery_gumbel=torch.from_numpy(np.asarray(g).copy()),
    )
    return noise, nxt


@functools.lru_cache(maxsize=None)
def _dispatch_noise_fn(R: int, Na: int, G: int, L: int):
    """Per env: the Gumbel draws the JAX dispatcher makes from its step key
    at temperature > 0, in its split order (policies/heuristic.py:143,
    :168 with :90, :187, :233 with :90)."""

    def one(key):
        k_assign, k_goal, k_ret = jax.random.split(key, 3)
        assign = jax.vmap(lambda k: jax.random.gumbel(k, (Na,)))(jax.random.split(k_assign, R))
        goal = jax.random.gumbel(k_goal, (Na, G))
        ret = jax.vmap(lambda k: jax.random.gumbel(k, (L,)))(jax.random.split(k_ret, Na))
        return assign, goal, ret

    return jax.jit(jax.vmap(one))


def jax_dispatch_noise(jparams, keys) -> DispatchNoise:
    """The port's DispatchNoise of B envs from their (B, 2) JAX step keys."""
    a, g, r = _dispatch_noise_fn(
        jparams.request_queue_size, jparams.num_agvs, jparams.num_goals, jparams.num_racks
    )(keys)
    return DispatchNoise(*(torch.from_numpy(np.asarray(x).copy()) for x in (a, g, r)))


def jax_reset_batch(jparams, B: int, seed: int):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.jit(jax.vmap(lambda k: jstep.reset(jparams, k)))(keys)


def jax_heuristic_init(jparams, B: int):
    h = jheur.init_state(jparams)
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), h)


def jax_policy_fn(jparams, jlayout):
    """Jitted, vmapped JAX dispatcher step: (states, hs) -> (actions, hs)."""
    policy = jheur.make_policy(jparams, jlayout)
    return jax.jit(jax.vmap(lambda s, h: policy(jparams, s, h)))


def jax_step_fn(jparams):
    """Jitted, vmapped JAX env step: (states, actions) -> (states, r, done, info)."""
    return jax.jit(jax.vmap(lambda s, a: jstep.step(jparams, s, a)))


def numpy_dict(tree: dict) -> dict:
    return {k: np.asarray(v) for k, v in tree.items()}


def torch_dict(tree: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in tree.items()}


def assert_same(expected: dict, got: dict, what: str):
    """Exact equality of every field in `expected` (numpy dicts), dtype
    included. The JAX state's PRNG `key` has no counterpart in the port."""
    for k, e in expected.items():
        if k == "key":
            continue
        assert k in got, f"{what}: port lacks {k}"
        g = got[k]
        assert g.dtype == e.dtype, f"{what}.{k}: dtype {g.dtype} != {e.dtype}"
        assert g.shape == e.shape, f"{what}.{k}: shape {g.shape} != {e.shape}"
        if not np.array_equal(g, e):
            bad = np.argwhere(g != e)[:5]
            raise AssertionError(
                f"{what}.{k}: {int((g != e).sum())} mismatches, first at "
                f"{bad.tolist()}: port {g[tuple(bad[0])]} vs jax {e[tuple(bad[0])]}"
            )


def served_windows():
    """Three medium windows of the port's own observations (partial,
    D = 435) from a seeded heuristic rollout, holding 5, 3 and 1 valid
    frames; invalid frames are zero."""
    _, _, pp, lay = both(MEDIUM)
    B = 3
    g = torch.Generator().manual_seed(17)
    state = heuristic_rollout(pp, lay, B, 20, g).state
    frames = []
    for _ in range(5):
        state = heuristic_rollout(pp, lay, B, 1, g, state=state).state
        frames.append(observe(pp, state))
    counts = torch.tensor([5, 3, 1], dtype=torch.int32)
    w = pt.init_window(B, 5, pp.num_agents, frames[0].shape[-1], device="cpu")
    for k, f in enumerate(frames):
        # Window b takes the first counts[b] frames only.
        keep = (k < counts)[:, None, None]
        pushed = pt.push_frame(w, f)
        w = pt.TemporalWindow(torch.where(keep[:, None], pushed.obs, w.obs),
                              torch.where(k < counts, pushed.count, w.count))
    return w


def jax_trajectory(jparams, jlayout, B: int, T: int, seed: int):
    """Every step's states of a JAX heuristic rollout of B envs."""
    policy, step = jax_policy_fn(jparams, jlayout), jax_step_fn(jparams)
    js, jh = jax_reset_batch(jparams, B, seed), jax_heuristic_init(jparams, B)
    states = []
    for _ in range(T):
        ja, jh = policy(js, jh)
        js, _, _, _ = step(js, ja)
        states.append(js)
    return states


def jax_observations(jparams, jlayout, B: int, T: int, seed: int, every: int = 1) -> np.ndarray:
    """(K, B, A, obs_len) JAX observations of every `every`-th state of a
    heuristic rollout (the reset state first)."""
    from swarm_ode_tpu.env.observations import observe as jobserve

    obs = jax.jit(jax.vmap(lambda s: jobserve(jparams, s)))
    states = [jax_reset_batch(jparams, B, seed)] + jax_trajectory(jparams, jlayout, B, T, seed)
    return np.stack([np.asarray(obs(s)) for s in states[::every]])


def jax_agent(cfg, jparams):
    """The JAX IQL, QMIX or COMA agent (and its network; COMA's encoder)
    that run_marl builds for `cfg` (a port RLRunConfig; its fields carry
    over), as swarm_ode_tpu/train/run_rl.py builds them."""
    from swarm_ode_tpu.rl.dqn import DQNConfig, IQLAgent
    from swarm_ode_tpu.rl.qmix import QMIXAgent, QMIXConfig
    from swarm_ode_tpu.train import run_rl as jrun

    known = {f.name for f in dataclasses.fields(jrun.RLRunConfig)}
    jcfg = jrun.RLRunConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in known})
    scale = 1.0 / float(max(jparams.grid_h, jparams.grid_w))
    gs_dim = 7 * jparams.num_agvs + 4 * jparams.num_pickers + 2 * jparams.num_racks
    if cfg.algo == "coma":
        from swarm_ode_tpu.models.hetero_gnn import HeteroGNNEncoder
        from swarm_ode_tpu.rl.coma import COMAAgent, COMAConfig

        encoder = HeteroGNNEncoder(cfg.hidden_dim, 2, coord_scale=scale)
        ccfg = COMAConfig(lr_actor=cfg.coma_lr_actor, lr_critic=cfg.coma_lr_critic,
                          entropy_coef=cfg.coma_entropy, entropy_decay=cfg.coma_entropy_decay,
                          coordinated=cfg.coordinated)
        if cfg.gamma is not None:
            ccfg.gamma = cfg.gamma
        return COMAAgent(encoder, jparams, jparams.num_actions, gs_dim, cfg.hidden_dim,
                         ccfg), encoder
    net = jrun._make_network(jcfg, jparams.num_actions, jparams.num_agvs,
                             jparams.num_pickers, coord_scale=scale)
    over = {k: getattr(cfg, k) for k in ("gamma", "epsilon_decay", "epsilon_min",
                                         "epsilon_start") if getattr(cfg, k) is not None}
    if cfg.algo == "iql":
        return IQLAgent(net, jparams, DQNConfig(batch_size=cfg.batch_size,
                                                coordinated=cfg.coordinated, **over)), net
    return QMIXAgent(net, jparams, gs_dim, QMIXConfig(
        batch_size=cfg.batch_size, value_transform=cfg.value_transform, td_clip=cfg.td_clip,
        huber_delta=cfg.huber_delta, target_tau=cfg.target_tau, coordinated=cfg.coordinated,
        **over)), net


def jax_example_graph(jparams, key):
    """run_marl's example graph: one reset's observation as a hetero graph
    (jitted: initialisers read only its shapes)."""
    from swarm_ode_tpu.env.observations import observe as jobserve
    from swarm_ode_tpu.graphs.hetero import hetero_graph_from_obs

    return jax.jit(lambda k: hetero_graph_from_obs(
        jparams, jobserve(jparams, jstep.reset(jparams, k))))(key)


def port_agent_state(jstate, port_agent, device="cpu"):
    """A JAX agent state carried into the port, in the port agent's
    parameter order."""
    from swarm_ode_tpu_torch.convert import agent_state_from_numpy, coma_state_from_numpy
    from swarm_ode_tpu_torch.rl.dqn import module_params

    if hasattr(port_agent, "critic"):
        return coma_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                     list(module_params(port_agent.actors)),
                                     list(module_params(port_agent.critic)), device)
    names = list(module_params(port_agent.net))
    if hasattr(port_agent, "mixer"):
        names = [f"q.{n}" for n in names] + [f"mixer.{n}" for n in module_params(port_agent.mixer)]
    return agent_state_from_numpy(jax.tree.map(np.asarray, jstate), names, device)


class JaxMarlDraws:
    """The draws of JAX's run_marl (swarm_ode_tpu/train/run_rl.py), rebuilt
    from its keys in its split order, in the form the port's run_marl takes
    (train/run_rl.MarlDraws): the resets of each stride (key, kr =
    split(key); reset per split(kr, B)), each step's env draws (from the
    envs' own state keys), each act's draws (kas = split(key, B + 1), then
    k1, k2 = split(ka) per env; COMA: the Gumbels of ka), each learn
    block's sample indices (key, ks = split(key); randint(ks, (batch,), 0,
    max(size, 1))), each COMA update's offsets (key, ks = split(key);
    randint(ks, (batch,), 1, max(min(window, size), 1) + 1)), and an
    evaluation probe's draws (key, ke = split(key))."""

    def __init__(self, jparams, key, coordinated: bool, algo: str = "qmix"):
        self.jparams, self.key, self.coordinated, self.algo = jparams, key, coordinated, algo
        self.env_keys = None
        A, n = jparams.num_agents, jparams.num_actions

        def one(ka):
            k1, k2 = jax.random.split(ka)
            if coordinated:
                return jax.random.uniform(k1, (A,)), jax.random.uniform(k2, (A, n))
            return jax.random.uniform(k2, (A,)), jax.random.gumbel(k1, (A, n))

        self._act = jax.jit(jax.vmap(one))
        self._gumbel = jax.jit(jax.vmap(lambda ka: jax.random.gumbel(ka, (A, n))))

    def reset(self, B: int):
        from swarm_ode_tpu_torch.convert import env_state_from_numpy

        self.key, kr = jax.random.split(self.key)
        js = jax.jit(jax.vmap(lambda k: jstep.reset(self.jparams, k)))(jax.random.split(kr, B))
        self.env_keys = js.key
        return env_state_from_numpy(fields(js), device="cpu")

    def step(self, B: int) -> StepNoise:
        noise, self.env_keys = jax_noise(self.jparams, self.env_keys)
        return noise

    def act(self, B: int):
        from swarm_ode_tpu_torch.rl.dqn import ActNoise

        kas = jax.random.split(self.key, B + 1)
        self.key = kas[0]
        if self.algo == "coma":
            return torch.from_numpy(np.array(self._gumbel(kas[1:])))
        u, row = self._act(kas[1:])
        return ActNoise(torch.from_numpy(np.array(u)), torch.from_numpy(np.array(row)))

    def sample(self, size: int, batch_size: int) -> torch.Tensor:
        self.key, ks = jax.random.split(self.key)
        idx = jax.random.randint(ks, (batch_size,), 0, max(size, 1))
        return torch.from_numpy(np.array(idx))

    def recent(self, size: int, batch_size: int, window: int) -> torch.Tensor:
        self.key, ks = jax.random.split(self.key)
        off = jax.random.randint(ks, (batch_size,), 1, max(min(window, size), 1) + 1)
        return torch.from_numpy(np.array(off))

    def split(self) -> "JaxMarlDraws":
        self.key, ke = jax.random.split(self.key)
        return JaxMarlDraws(self.jparams, ke, self.coordinated, self.algo)


# The committed serving blobs whose weights the port carries as
# swarm_ode_tpu_torch/weights/<name>.npz (convert.committed_params).
REPO = pathlib.Path(__file__).resolve().parent.parent
COMMITTED_BLOBS = ("gde_medium_h4w", "policy_qmix_coordtrain20k", "policy_qmix_large_coordtrain",
                   "policy_dagger_clone_r4", "policy_dagger_clone_large_r4")


def _program_ops(blob: bytes):
    """The ops of an exported program other than its constants, in program
    order: (op name, result types, operands), each operand the f32 array of
    the constant that defines it, False for a constant of another type, or
    None for any other value. Arrays are read from the module's attributes,
    so they are exact."""
    from jax import export as jax_export
    from jax._src.interpreters import mlir
    from jax._src.lib.mlir import ir

    ops = []
    with mlir.make_ir_context():
        module = ir.Module.parse(jax_export.deserialize(blob).mlir_module())

        def constant(value):
            owner = value.owner
            if isinstance(owner, ir.Block) or owner.operation.name != "stablehlo.constant":
                return None
            attr = owner.attributes["value"]
            ttype = ir.RankedTensorType(attr.type)
            if str(ttype.element_type) != "f32":
                return False
            if attr.is_splat:
                return np.full(tuple(ttype.shape), ir.FloatAttr(attr.get_splat_value()).value,
                               np.float32)
            return np.array(ir.DenseFPElementsAttr(attr)).reshape(tuple(ttype.shape))

        def walk(op):
            for region in op.regions:
                for block in region.blocks:
                    for o in block.operations:
                        if o.operation.name not in ("func.func", "stablehlo.constant"):
                            ops.append((o.operation.name, tuple(str(r.type) for r in o.results),
                                        [constant(v) for v in o.operands]))
                        walk(o.operation)

        walk(module.operation)
    return ops


def _blob_program(name: str, meta: dict):
    """(the parameter tree's shapes, export) of a committed blob's model,
    built as its export script (experiments/export_gde.py,
    export_policy.py) builds it; export(leaves) exports that program again
    with the JAX package's serving functions, the parameters `leaves`
    ('/'-joined flax paths -> arrays) baked in."""
    from swarm_ode_tpu import serving as jserving

    if name.startswith("gde"):
        from swarm_ode_tpu.graphs.temporal import TemporalWindow, build_temporal_graph
        from swarm_ode_tpu.models.gde import GraphODE as JGraphODE

        jcfg = JEnvConfig.from_env_id(meta["env"])
        jp = jmake_params(jcfg, jbuild_layout(jcfg))
        W, N, D = meta["window"], meta["num_agents"], meta["obs_dim"]
        model = JGraphODE(node_dim=D, num_agvs=int(jp.num_agvs), num_pickers=int(jp.num_pickers),
                          hidden_dim=meta["hidden_dim"])
        w0 = TemporalWindow(obs=jnp.zeros((W, N, D), jnp.float32), count=jnp.int32(W))
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), build_temporal_graph(
            w0, model.num_agvs, 5.0), jnp.array([0.0, 1.0])))

        def export(tree):
            fn = jserving.make_gde_fn(model, tree, horizon=meta["horizon"])
            return jserving.export_gde(fn, window=W, num_agents=N, obs_dim=D)
    else:
        from swarm_ode_tpu.env.observations import observe as jobserve
        from swarm_ode_tpu.graphs.hetero import hetero_graph_from_obs
        from swarm_ode_tpu.train.run_rl import RLRunConfig, _make_network

        jcfg = JEnvConfig.from_env_id(meta["env_id"])
        jp = jmake_params(jcfg, jbuild_layout(jcfg))
        net = _make_network(RLRunConfig(net=meta["net"], hidden_dim=meta["hidden_dim"]),
                            jp.num_actions, jp.num_agvs, jp.num_pickers,
                            coord_scale=1.0 / float(max(jp.grid_h, jp.grid_w)))
        key = jax.random.PRNGKey(0)
        obs = jax.jit(lambda k: jobserve(jp, jstep.reset(jp, k)))(key)
        shapes = jax.eval_shape(lambda: net.init(key, hetero_graph_from_obs(jp, obs)))

        def export(tree):
            policy = jserving.make_policy_fn(jp, net, tree, coordinated=meta["coordinated"],
                                             temperature=meta["temperature"])
            return jserving.export_policy(policy, obs, stochastic=meta["temperature"] > 0)

    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    names = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in paths]
    return ({n: s.shape for n, (_, s) in zip(names, paths)},
            lambda leaves: export(jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(leaves[n]) for n in names])))


def blob_weights(name: str):
    """(leaves, meta) of the committed blob results_data/<name>.stablehlo:
    its model's flax parameters by '/'-joined path, read out of the blob's
    constants, and its .stablehlo.json fields with the blob's sha256 and
    `zeroed`, the leaves the blob does not hold (zeros here).

    The program is exported again (`_blob_program`) with parameters that
    all differ, which tells which constant is which leaf; walked op by op
    beside the committed program (the same ops, or this raises), each such
    constant's operand slot there holds the trained leaf. The blobs were
    written by a JAX that folded equal constants into one (the biases of
    relations into one node type train alike), so one committed constant
    may serve several leaves. A leaf the program never reads (dropped by
    jit, as the last conv block's location-bound relations are) is absent
    from both programs."""
    import hashlib
    import json

    path = REPO / "results_data" / f"{name}.stablehlo"
    blob = path.read_bytes()
    meta = json.loads(path.with_name(path.name + ".json").read_text())
    shapes, export = _blob_program(name, meta)
    rng = np.random.RandomState(0)
    marked = {n: rng.uniform(1.0, 2.0, s).astype(np.float32) for n, s in shapes.items()}
    by_value = {a.tobytes(): n for n, a in marked.items()}
    fresh, committed = _program_ops(export(marked)), _program_ops(blob)
    if len(fresh) != len(committed):
        raise ValueError(f"{name}: {len(committed)} ops, the JAX package's export {len(fresh)}")
    leaves = {}
    for (f_op, f_types, f_args), (c_op, c_types, c_args) in zip(fresh, committed):
        if (f_op, f_types, len(f_args)) != (c_op, c_types, len(c_args)):
            raise ValueError(f"{name}: op {c_op} {c_types} where the JAX package has "
                             f"{f_op} {f_types}")
        for f, c in zip(f_args, c_args):
            leaf = by_value.get(f.tobytes()) if isinstance(f, np.ndarray) else None
            if leaf is None:
                continue
            if not isinstance(c, np.ndarray) or c.shape != marked[leaf].shape:
                raise ValueError(f"{name}: {leaf} reads no f32 constant of its shape")
            if leaf in leaves and not np.array_equal(leaves[leaf], c):
                raise ValueError(f"{name}: {leaf} reads two different constants")
            leaves[leaf] = c
    zeroed = sorted(set(marked) - set(leaves))
    leaves.update({n: np.zeros_like(marked[n]) for n in zeroed})
    meta = dict(meta, sha256=hashlib.sha256(blob).hexdigest(), zeroed=zeroed)
    return {n: leaves[n] for n in marked}, meta


def write_committed_weights(out_dir=REPO / "swarm_ode_tpu_torch" / "weights") -> None:
    """Write swarm_ode_tpu_torch/weights/<name>.npz for every committed blob:
    the leaves of `blob_weights` under their paths, and `meta` (JSON)."""
    import json

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in COMMITTED_BLOBS:
        leaves, meta = blob_weights(name)
        np.savez(out_dir / f"{name}.npz", meta=np.array(json.dumps(meta, sort_keys=True)), **leaves)


def sharded_heuristic_rollout(env_id: str, B: int, T: int, seed: int) -> dict:
    """This rank's share of a heuristic rollout of B envs over the process
    group's ranks (a rank function for parallel.mesh.launch; in a process
    without a group, the whole rollout): the resets and every step's draws
    are made for all B from one seeded generator, as one device would make
    them, and each rank keeps its B/n envs (mesh.shard_batch). Returns its
    (T, B/n, ...) agent positions, actions, rewards and deliveries."""
    from swarm_ode_tpu_torch.env.step import draw_noise, reset
    from swarm_ode_tpu_torch.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(("dp",), device="cpu")
    cfg = PEnvConfig.from_env_id(env_id)
    lay = pbuild_layout(cfg)
    params = pmake_params(cfg, lay, "cpu")
    g = torch.Generator().manual_seed(seed)
    state = shard_batch(mesh, reset(params, B, g))
    noise = [shard_batch(mesh, draw_noise(params, B, g)) for _ in range(T)]
    ro = heuristic_rollout(params, lay, B // mesh.size, T, state=state, noise=noise, record=True)
    return {"xy": torch.stack([s.agent_xy for *_, s in ro.trace]),
            "actions": torch.stack([a for a, *_ in ro.trace]),
            "rewards": torch.stack([r for _, r, *_ in ro.trace]),
            "deliveries": torch.stack([i["shelf_deliveries"] for _, _, i, _ in ro.trace])}
