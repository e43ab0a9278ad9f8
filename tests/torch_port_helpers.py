"""Shared helpers of the tests that hold swarm_ode_tpu_torch against the JAX
package: JAX structs to numpy dicts, the JAX step's random draws,
field-by-field comparison, the flagship GDE's weights read out of its
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
from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

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
