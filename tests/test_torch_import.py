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
    "swarm_ode_tpu_torch.data.dataset",
    "swarm_ode_tpu_torch.utils.logging",
    "swarm_ode_tpu_torch.utils.checkpoint",
    "swarm_ode_tpu_torch.utils.optim",
    "swarm_ode_tpu_torch.train.train_gde",
    "swarm_ode_tpu_torch.entry",
    "swarm_ode_tpu_torch.utils.metrics",
    "swarm_ode_tpu_torch.env.env",
    "swarm_ode_tpu_torch.env.invariants",
    "swarm_ode_tpu_torch.env.gym_adapter",
    "swarm_ode_tpu_torch.env.wrappers",
    "swarm_ode_tpu_torch.env.rendering",
    "swarm_ode_tpu_torch.data.hdf5_logger",
    "swarm_ode_tpu_torch.data.collect",
    "swarm_ode_tpu_torch.graphs.hetero",
    "swarm_ode_tpu_torch.models.init",
    "swarm_ode_tpu_torch.models.hetero_gnn",
    "swarm_ode_tpu_torch.models.gnode",
    "swarm_ode_tpu_torch.models.qmix",
    "swarm_ode_tpu_torch.rl.replay",
    "swarm_ode_tpu_torch.rl.coordination",
    "swarm_ode_tpu_torch.rl.dqn",
    "swarm_ode_tpu_torch.rl.qmix",
    "swarm_ode_tpu_torch.train.run_rl",
    "swarm_ode_tpu_torch.models.coma",
    "swarm_ode_tpu_torch.rl.coma",
    "swarm_ode_tpu_torch.rl.draws",
    "swarm_ode_tpu_torch.rl.ppo",
    "swarm_ode_tpu_torch.train.train_bc",
    "swarm_ode_tpu_torch.models.gru",
    "swarm_ode_tpu_torch.train.train_baselines",
    "swarm_ode_tpu_torch.utils.tree",
    "swarm_ode_tpu_torch.utils.profiling",
    "swarm_ode_tpu_torch.parallel.mesh",
    "swarm_ode_tpu_torch.analysis",
)
# Modules a fresh interpreter must not load when it imports the port: JAX,
# the JAX package and its training stack, h5py (needed only to decode or
# write an HDF5 file) and matplotlib (only to render), both absent where the
# port runs on the card.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "matplotlib",
             "swarm_ode_tpu")


def test_port_imports_without_jax():
    """Every module of the port in one fresh interpreter (gymnasium, which
    env/wrappers.py needs, is installed here)."""
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
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


@pytest.mark.parametrize("module", ["swarm_ode_tpu_torch.policies.heuristic",
                                    "swarm_ode_tpu_torch.data.dataset"])
def test_command_lines_start_without_jax(module):
    """`python -m <module> --help` for the port's own command lines (run,
    parity, render; build-cache) in a fresh interpreter: runpy warns of
    nothing (no module of the package imports the one it runs) and none
    of FORBIDDEN is loaded."""
    code = (
        "import runpy, sys, warnings\n"
        "warnings.simplefilter('error')\n"
        f"sys.argv = [{module!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == "ok" and "usage:" in res.stdout


def test_convert_loads_no_trainer():
    """The interop layer (convert) loads the optimizer's state type and not
    the trainer above it, nor the dataset, checkpoint and logging modules
    the trainer pulls in."""
    code = (
        "import sys\n"
        "import swarm_ode_tpu_torch.convert\n"
        "upper = ('train.', 'data.', 'utils.checkpoint', 'utils.logging')\n"
        "bad = sorted(m for m in sys.modules if m.startswith('swarm_ode_tpu_torch.')\n"
        "             and m[len('swarm_ode_tpu_torch.'):].startswith(upper))\n"
        "assert not bad, bad\n"
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
                assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                                 "swarm_ode_tpu"), (
                    f"{path.relative_to(REPO)}: {s}"
                )


def test_learning_from_the_dispatcher_needs_no_h5py(tmp_path):
    """train_bc, collect_dagger and run_mappo import no h5py, and train_bc
    runs from arrays in memory with h5py unimportable (the card's machine
    has none): only load_decision_arrays reads HDF5 files."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None  # any import of h5py now fails\n"
        "import numpy as np, torch\n"
        "from swarm_ode_tpu_torch.train import train_bc\n"
        "from swarm_ode_tpu_torch.rl import ppo\n"
        "obs = np.zeros((12, 5, 119), np.float16)\n"
        "act = np.zeros((12, 5), np.int32)\n"
        "busy = np.zeros((12, 5), bool)\n"
        "ep = np.repeat(np.arange(3, dtype=np.int32), 4)\n"
        "cfg = train_bc.BCConfig(env_id='tarware-tiny-3agvs-2pickers-partialobs-v1', net='gnn',\n"
        "                        hidden_dim=8, epochs=1, batch_size=4, device='cpu',\n"
        f"                        checkpoint_dir={str(tmp_path)!r})\n"
        "out = train_bc.train_bc(cfg, verbose=False, arrays=(obs, act, busy, ep))\n"
        "assert np.isfinite(out['history'][0]['train_loss'])\n"
        "try:\n"
        "    train_bc.load_decision_arrays(['x.h5'])\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


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
        "swarm_ode_tpu_torch.convert.adamw_state_from_numpy",
        "swarm_ode_tpu_torch.train.train_gde.train_gde",
        "swarm_ode_tpu_torch.entry.entry",
        "swarm_ode_tpu_torch.make",
        "swarm_ode_tpu_torch.env.env.WarehouseEnv.__init__",
        "swarm_ode_tpu_torch.env.gym_adapter.Warehouse.__init__",
        "swarm_ode_tpu_torch.data.collect.collect_data",
        "swarm_ode_tpu_torch.convert.flax_params_to_state_dict",
        "swarm_ode_tpu_torch.convert.agent_state_from_numpy",
        "swarm_ode_tpu_torch.convert.coma_state_from_numpy",
        "swarm_ode_tpu_torch.convert.mappo_params_from_numpy",
        "swarm_ode_tpu_torch.convert.committed_params",
        "swarm_ode_tpu_torch.serving.load_policy",
        "swarm_ode_tpu_torch.serving.load_gde",
        "swarm_ode_tpu_torch.analysis.evaluate_gde",
        "swarm_ode_tpu_torch.analysis.evaluate_baseline",
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


def test_marl_runs_on_the_card_by_default():
    """RLRunConfig (and so run_marl and its CLI) defaults to the card; without
    one, run_marl raises rather than falling back to the CPU."""
    from swarm_ode_tpu_torch.train import run_rl

    cfg = run_rl.RLRunConfig(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1",
                             num_episodes=0, hidden_dim=8)
    assert cfg.device == "cuda"
    assert inspect.signature(run_rl.main).parameters["argv"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            run_rl.run_marl(cfg, verbose=False)


def test_recurrent_paths_run_on_the_card_by_default():
    """BaselineTrainConfig (so train_baseline and its CLI) defaults to the
    card, and so does run_marl with net="gru"; without one, both raise
    rather than falling back to the CPU."""
    from swarm_ode_tpu_torch.train import run_rl, train_baselines

    assert train_baselines.BaselineTrainConfig().device == "cuda"
    assert inspect.signature(train_baselines.main).parameters["argv"].default is None
    cfg = run_rl.RLRunConfig(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1", algo="iql",
                             net="gru", num_episodes=0, hidden_dim=8)
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            run_rl.run_marl(cfg, verbose=False)


def test_learners_from_the_dispatcher_run_on_the_card_by_default():
    """BCConfig and MAPPOConfig (so train_bc, run_mappo) default to the card;
    without one, run_mappo raises rather than falling back to the CPU."""
    from swarm_ode_tpu_torch.rl import ppo
    from swarm_ode_tpu_torch.train import train_bc

    assert train_bc.BCConfig().device == "cuda"
    cfg = ppo.MAPPOConfig(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1", hidden_dim=8)
    assert cfg.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            ppo.run_mappo(cfg, verbose=False)
