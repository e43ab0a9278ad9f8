"""Shared helpers of the tests that hold swarm_ode_tpu_torch against the JAX
package: JAX structs to numpy dicts, the JAX step's and the stochastic
dispatcher's random draws, field-by-field comparison, the flagship GDE's weights read out of its
exported blob, and medium windows of observations to serve."""
from __future__ import annotations

import dataclasses
import functools
import pathlib
import re

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


_CONST_RE = re.compile(
    r"stablehlo\.constant dense<(?P<val>[^>]*)> : tensor<(?P<shape>[0-9x]*)xf32>"
)


def _mlir_constant(val: str, shape) -> np.ndarray:
    if val.startswith('"0x'):
        a = np.frombuffer(bytes.fromhex(val[3:-1]), dtype="<f4")
    else:
        nums = val.replace("[", " ").replace("]", " ").replace(",", " ").split()
        a = np.array([float(v) for v in nums], np.float32)
        if a.size == 1:
            a = np.full(int(np.prod(shape)), a[0], np.float32)
    return a.reshape(shape).copy()


def gde_params_from_stablehlo(path, hidden_dim: int = 64) -> dict:
    """The flagship GDE's weights, read out of its exported StableHLO blob
    (serving.export_gde), as the numpy parameter tree of the JAX model.

    The blob bakes its parameters in as f32 constants of the main function,
    in the order the forward pass first uses them: per SAGE layer the lin_l
    kernel, the lin_l bias, the lin_r kernel, then the decoder's kernel and
    bias. Constants are matched to that list by shape, in order; others
    (the time span) are skipped. tests/test_torch_gde.py proves the mapping
    by matching the blob's own predictions."""
    from jax import export as jax_export

    exported = jax_export.deserialize(pathlib.Path(path).read_bytes())
    text = exported.mlir_module()
    main = text[text.index("@main("):]
    end = main.find("func.func")  # the next function, if any
    main = main if end < 0 else main[:end]
    D, H = exported.in_avals[0].shape[-1], hidden_dim
    names = []
    for conv, (i, o) in (("conv1", (D, H)), ("conv2", (H, H)), ("conv3", (H, D))):
        names += [((conv, "lin_l", "kernel"), (i, o)), ((conv, "lin_l", "bias"), (o,)),
                  ((conv, "lin_r", "kernel"), (i, o))]
    names += [(("decoder", "kernel"), (D, 2)), (("decoder", "bias"), (2,))]
    tree = {"func": {"params": {}}, "decoder": {"params": {"position_decoder": {}}}}
    k = 0
    for m in _CONST_RE.finditer(main):
        if k == len(names):
            break
        shape = tuple(int(v) for v in m.group("shape").split("x"))
        key, want = names[k]
        if shape != want:
            continue
        a = _mlir_constant(m.group("val"), shape)
        if key[0] == "decoder":
            tree["decoder"]["params"]["position_decoder"][key[1]] = a
        else:
            conv, lin, leaf = key
            node = tree["func"]["params"].setdefault(conv, {"DenseSAGEConv_0": {}})
            node["DenseSAGEConv_0"].setdefault(lin, {})[leaf] = a
        k += 1
    if k != len(names):
        raise ValueError(f"found {k} of the {len(names)} weight constants in {path}")
    return tree


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
