"""The port's `observe` against the JAX package's, bit for bit.

States are JAX reset states with their dynamic fields (carried shelves,
targets, last actions) drawn at random with numpy, so that every piece of
the observation (carrying, requested, toggling, targets, shelf state) takes
both values; both packages observe the same states, carried across with
`convert`.
"""
import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.env.observations import observe as jobserve
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.env.observations import obs_lengths, observe
from torch_port_helpers import MEDIUM, TINY, both, fields, jax_reset_batch

CASES = [
    (TINY, {}),
    ("tarware-tiny-3agvs-2pickers-globalobs-v1", {}),
    (MEDIUM, {}),
    ("tarware-medium-19agvs-9pickers-globalobs-v1", {}),
    (MEDIUM, dict(normalised_coordinates=True)),
    ("tarware-tiny-4agvs-0pickers-partialobs-v1", {}),
    ("tarware-tiny-4agvs-0pickers-globalobs-v1", {}),
]


def _random_states(jp, B, seed):
    js = jax_reset_batch(jp, B, seed=seed)
    rng = np.random.RandomState(seed)
    A, S = jp.num_agents, jp.num_shelves
    shape = (B, A)
    carrying = np.where(rng.rand(*shape) < 0.5, rng.randint(1, S + 1, shape), 0)
    # A carried shelf's requested flag needs some carried ids in the queue.
    queue = np.asarray(js.request_queue).copy()
    queue[:, 0] = carrying[:, 0].clip(min=1)
    target = np.where(rng.rand(*shape) < 0.7, rng.randint(1, jp.num_actions, shape), 0)
    return js.replace(
        agent_carrying=jax.numpy.asarray(carrying, np.int32),
        agent_target=jax.numpy.asarray(target, np.int32),
        agent_req_action=jax.numpy.asarray(rng.randint(0, 5, shape), np.int32),
        request_queue=jax.numpy.asarray(queue, np.int32),
    )


def _case_id(case):
    env_id, ov = case
    return "-".join([env_id.split("-", 1)[1].rsplit("-", 1)[0]] + [f"{k}={v}" for k, v in ov.items()])


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_observe_matches_jax(case):
    env_id, overrides = case
    jp, _, pp, _ = both(env_id, **overrides)
    js = _random_states(jp, 4, seed=13)
    ref = np.asarray(jax.jit(jax.vmap(lambda s: jobserve(jp, s)))(js))
    got = observe(pp, convert.env_state_from_numpy(fields(js), device="cpu"))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert max(obs_lengths(pp)) == ref.shape[-1]
    # The random fields reached both values of every flag.
    assert (ref[..., :3] == 1).any() and (ref[..., :3] == 0).any()


def test_partial_obs_width_of_the_flagship():
    """The GDE flagship's node features: medium partial obs, D = 435."""
    _, _, pp, _ = both(MEDIUM)
    assert obs_lengths(pp) == (435, 169)
