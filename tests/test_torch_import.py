"""swarm_ode_tpu_torch imports without JAX, importing it builds nothing, and
its entry points default to the card."""
import importlib
import inspect
import pathlib
import subprocess
import sys

import pytest
import torch

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env.state import make_params

REPO = pathlib.Path(__file__).resolve().parent.parent

SLICE_MODULES = (
    "swarm_ode_tpu_torch",
    "swarm_ode_tpu_torch.config",
    "swarm_ode_tpu_torch.definitions",
    "swarm_ode_tpu_torch.convert",
    "swarm_ode_tpu_torch.env.layout",
    "swarm_ode_tpu_torch.env.state",
    "swarm_ode_tpu_torch.env.queries",
    "swarm_ode_tpu_torch.env.observations",
    "swarm_ode_tpu_torch.env.pathfinding",
    "swarm_ode_tpu_torch.env.step",
    "swarm_ode_tpu_torch.ops.take",
    "swarm_ode_tpu_torch.ops._build",
    "swarm_ode_tpu_torch.ops.bfs_pallas",
    "swarm_ode_tpu_torch.ops.bfs_bitpack",
    "swarm_ode_tpu_torch.policies.heuristic",
    "swarm_ode_tpu_torch.graphs.temporal",
    "swarm_ode_tpu_torch.ops.segment_pallas",
    "swarm_ode_tpu_torch.ops.segment",
    "swarm_ode_tpu_torch.ops.sage",
    "swarm_ode_tpu_torch.ops.odeint",
    "swarm_ode_tpu_torch.models.gde",
    "swarm_ode_tpu_torch.serving",
)


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'swarm_ode_tpu' or m.startswith('swarm_ode_tpu.'))\n"
        "assert not bad, bad\n"
        "from swarm_ode_tpu_torch.ops import _build\n"
        "assert _build._library is None\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_every_module_of_the_port_is_checked():
    """SLICE_MODULES names every module of the package, so the import check
    above covers each one."""
    found = {
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "swarm_ode_tpu_torch").rglob("*.py") if p.name != "__init__.py"
    }
    assert found <= set(SLICE_MODULES), sorted(found - set(SLICE_MODULES))


def test_port_sources_never_name_jax():
    """No module of the port, nor its GPU scripts, imports jax or the JAX
    package, even lazily."""
    scripts = [REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_rollout.py"]
    for path in [*(REPO / "swarm_ode_tpu_torch").rglob("*.py"), *scripts]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "swarm_ode_tpu"), (
                    f"{path.relative_to(REPO)}: {s}"
                )


def _device_defaults():
    """{qualified name: default of its `device` parameter} over every
    function and method defined in the port's modules."""
    found = {}
    for name in SLICE_MODULES:
        mod = importlib.import_module(name)
        for obj in vars(mod).values():
            members = vars(obj).values() if inspect.isclass(obj) else [obj]
            for fn in members:
                fn = inspect.unwrap(fn) if callable(fn) else fn
                if not inspect.isfunction(fn) or fn.__module__ != name:
                    continue
                param = inspect.signature(fn).parameters.get("device")
                if param is not None:
                    found[f"{name}.{fn.__qualname__}"] = param.default
    return found


def test_device_parameters_default_to_the_card():
    """A function that takes a `device` puts its tensors on the card unless
    the caller asks for the CPU: its default is "cuda", or it has none."""
    found = _device_defaults()
    assert {k: v for k, v in found.items() if v not in ("cuda", inspect.Parameter.empty)} == {}
    entry_points = {
        "swarm_ode_tpu_torch.env.state.make_params",
        "swarm_ode_tpu_torch.graphs.temporal.init_window",
        "swarm_ode_tpu_torch.convert.env_state_from_numpy",
        "swarm_ode_tpu_torch.convert.heuristic_state_from_numpy",
        "swarm_ode_tpu_torch.convert.env_params_from_numpy",
        "swarm_ode_tpu_torch.convert.gde_params_from_numpy",
    }
    assert {k for k, v in found.items() if v == "cuda"} >= entry_points


def test_make_params_without_a_card_raises():
    """The default device is the card, with no fallback: without one,
    make_params raises (decided here, when the test runs)."""
    cfg = EnvConfig.from_env_id("tarware-tiny-3agvs-2pickers-partialobs-v1")
    if torch.cuda.is_available():
        assert make_params(cfg).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            make_params(cfg)
