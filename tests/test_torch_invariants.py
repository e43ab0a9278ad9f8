"""The port's invariant checker against the JAX package's on states the JAX
simulation itself reaches: its own medium rollout (B = 64, seed 0) puts two
agents of one layer (two AGVs, or two pickers) on one cell with neither
fixing a clash, which JAX's check_state flags, and the port's checker flags
the same envs with the same message. The port's step equals JAX's bit for
bit, so it reaches those states too (ROADMAP.md, queue 3)."""
import jax
import numpy as np
from jax.experimental import checkify

from swarm_ode_tpu.env import invariants as jinv
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.env import invariants as pinv
from torch_port_helpers import (
    MEDIUM,
    both,
    fields,
    jax_heuristic_init,
    jax_policy_fn,
    jax_reset_batch,
    jax_step_fn,
)

OVERLAP = "same-layer agents overlap without fixing-clash"


def test_checker_matches_jax_on_the_reachable_overlap():
    jp, jl, pp, _ = both(MEDIUM)
    B, T = 64, 50
    policy, step = jax_policy_fn(jp, jl), jax_step_fn(jp)
    check = jax.jit(jax.vmap(
        lambda s: checkify.checkify(lambda st: jinv.check_state(jp, st))(s)[0]))
    one = jax.jit(lambda s: checkify.checkify(lambda st: jinv.check_state(jp, st))(s)[0])
    js, jh = jax_reset_batch(jp, B, 0), jax_heuristic_init(jp, B)
    broken = 0
    for t in range(T):
        a, jh = policy(js, jh)
        js, *_ = step(js, a)
        ps = convert.env_state_from_numpy(fields(js), device="cpu")
        got = {msg: (~ok).nonzero().flatten().tolist() for msg, ok in pinv.state_flags(pp, ps)}
        bad = {m: e for m, e in got.items() if e}
        assert (check(js).get() is None) == (not bad), f"step {t}: {bad}"
        if not bad:
            continue
        broken += 1
        assert set(bad) == {OVERLAP}, f"step {t}: {bad}"
        for b in bad[OVERLAP]:
            msg = one(jax.tree.map(lambda x: x[b], js)).get()
            assert msg is not None and OVERLAP in msg
            xy = np.asarray(js.agent_xy[b])
            same = (xy[:, None] == xy[None]).all(-1) & ~np.eye(len(xy), dtype=bool)
            assert not np.asarray(js.agent_fixing_clash[b])[same.any(1)].any()
    assert broken > 0, "JAX's rollout no longer reaches the picker overlap"
