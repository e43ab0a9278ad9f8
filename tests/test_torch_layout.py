"""The port's layout, EnvParams and occupancy grids equal the JAX package's,
on all five predefined sizes (through swarm_ode_tpu_torch.convert)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from swarm_ode_tpu.env.state import occupancy_grids as jax_occupancy_grids
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.env.state import occupancy_grids
from torch_port_helpers import MEDIUM, TINY, assert_same, both, fields, jax_reset_batch

SIZES = {
    "tiny": "tarware-tiny-3agvs-2pickers-partialobs-v1",
    "small": "tarware-small-6agvs-3pickers-partialobs-v1",
    "medium": "tarware-medium-19agvs-9pickers-partialobs-v1",
    "large": "tarware-large-12agvs-7pickers-globalobs-v1",
    "extralarge": "tarware-extralarge-14agvs-7pickers-partialobs-v1",
}


@pytest.mark.parametrize("size", list(SIZES))
def test_layout_and_params_match_jax(size):
    jp, jl, pp, pl = both(SIZES[size])
    for f in dataclasses.fields(jl):
        a, b = getattr(jl, f.name), getattr(pl, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name != "config":
            assert a == b, f.name
    ported = convert.env_params_to_numpy(pp)
    assert_same(fields(jp), ported, f"{size}.params")
    for f in dataclasses.fields(jp):
        v = getattr(jp, f.name)
        if f.name == "bfs_backend":
            # The JAX package resolves 'auto' by platform ('xla' on the CPU);
            # the port keeps 'auto', its compacted branch.
            assert v == "xla" and ported[f.name] == "auto", (v, ported[f.name])
        elif isinstance(v, (int, float, str, bool)):
            assert ported[f.name] == v, f.name
    # The bit-packed kernel is the default wherever the walled row fits a word.
    assert pp.bfs_kernel == "bitpack32"


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_explicit_bfs_backend_matches_jax(backend):
    jp, _, pp, _ = both(TINY, bfs_backend=backend)
    assert pp.bfs_backend == jp.bfs_backend == backend


def test_unknown_bfs_backend_is_refused():
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.state import make_params

    with pytest.raises(ValueError, match="bfs_backend"):
        make_params(EnvConfig.from_env_id(TINY, bfs_backend="triton"), device="cpu")


def test_params_round_trip_through_numpy():
    _, _, pp, _ = both(TINY)
    back = convert.env_params_from_numpy(convert.env_params_to_numpy(pp), device="cpu")
    for f in dataclasses.fields(pp):
        a, b = getattr(pp, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_bfs_kernel_auto_rule():
    """'auto' picks bitpack32 iff W+1 < 32 (the _plan guard), and an
    explicit choice stands."""
    _, _, pp, _ = both(TINY, bfs_kernel="int32")
    assert pp.bfs_kernel == "int32"
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.state import make_params

    wide = EnvConfig(shelf_rows=1, shelf_columns=9, column_height=2)  # W = 38
    assert make_params(wide, device="cpu").bfs_kernel == "int32"


@pytest.mark.parametrize("env_id", [TINY, MEDIUM])
def test_occupancy_grids_match_jax(env_id):
    jp, _, pp, _ = both(env_id)
    js = jax_reset_batch(jp, 3, seed=5)
    # Some carried shelves, so the carried layer is not empty.
    carrying = np.zeros(np.asarray(js.agent_carrying).shape, np.int32)
    carrying[:, 0] = [1, 2, 3]
    js = js.replace(agent_carrying=jax.numpy.asarray(carrying))
    ref = jax.vmap(lambda s: jax_occupancy_grids(jp, s))(js)
    got = occupancy_grids(pp, convert.env_state_from_numpy(fields(js), device="cpu"))
    for name, a, b in zip(("agv", "picker", "shelf", "carried"), ref, got):
        assert np.array_equal(np.asarray(a), b.numpy()), name
