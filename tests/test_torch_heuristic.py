"""The port's FIFO dispatcher against the JAX package's, bit for bit: the
actions and the whole HeuristicState after every step of a JAX rollout, and
the picker zones on every size."""
import numpy as np
import pytest
import torch

from swarm_ode_tpu.policies.heuristic import picker_zones as jax_picker_zones
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.policies import heuristic as pheur
from torch_port_helpers import (
    MEDIUM,
    TINY,
    assert_same,
    both,
    fields,
    jax_heuristic_init,
    jax_policy_fn,
    jax_reset_batch,
    jax_step_fn,
)


@pytest.mark.parametrize("env_id,B,T", [
    (TINY, 4, 40),
    (MEDIUM, 3, 40),
    ("tarware-small-5agvs-0pickers-globalobs-v1", 2, 30),
])
def test_policy_matches_jax(env_id, B, T):
    jp, jl, pp, pl = both(env_id)
    policy, step = jax_policy_fn(jp, jl), jax_step_fn(jp)
    port_policy = pheur.make_policy(pp, pl)
    js = jax_reset_batch(jp, B, seed=7)
    jh = jax_heuristic_init(jp, B)
    assigned = 0
    for t in range(T):
        ph = convert.heuristic_state_from_numpy(fields(jh), device="cpu")
        pa, ph = port_policy(pp, convert.env_state_from_numpy(fields(js), device="cpu"), ph)
        ja, jh = policy(js, jh)
        assert_same({"actions": np.asarray(ja)}, {"actions": pa.numpy()}, f"step {t}")
        assert_same(fields(jh), convert.heuristic_state_to_numpy(ph), f"step {t} h")
        assigned += int((pa > 0).sum())
        js, _, _, _ = step(js, ja)
    assert assigned > 0


@pytest.mark.parametrize("env_id", [
    TINY,
    "tarware-small-6agvs-3pickers-partialobs-v1",
    MEDIUM,
    "tarware-large-12agvs-7pickers-globalobs-v1",
    "tarware-extralarge-14agvs-7pickers-partialobs-v1",
])
def test_picker_zones_match_jax(env_id):
    jp, jl, pp, pl = both(env_id)
    for n in (1, 2, pp.num_pickers):
        np.testing.assert_array_equal(
            pheur.picker_zones(pl, n), jax_picker_zones(jl, n)
        )


def test_init_state_shapes():
    _, _, pp, _ = both(MEDIUM)
    h = pheur.init_state(pp, 5)
    assert h.agv_mission.shape == (5, pp.num_agvs) and h.picker_loc.shape == (5, pp.num_pickers)
    assert h.agv_at_loc.dtype == torch.bool and h.timestep.dtype == torch.int32
