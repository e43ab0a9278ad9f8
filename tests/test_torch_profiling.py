"""utils/profiling.py and full_registration in the port against the JAX
package's, on the CPU: the timers' arithmetic under one fake clock, a trace
file written, and the gym registration in a fresh interpreter."""
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import torch

from swarm_ode_tpu.utils import profiling as jprof
from swarm_ode_tpu_torch.utils import profiling as pprof

REPO = pathlib.Path(__file__).resolve().parent.parent
# Uneven clock readings, so that every total and mean differs.
TICKS = (0.5, 0.75, 1.0, 1.625, 2.0, 2.0625, 3.0, 3.5, 4.0, 5.25, 6.0, 6.125, 7.0, 7.75)


def _fake_clock(monkeypatch):
    ticks = iter(TICKS)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def _timed(prof, block_on, monkeypatch):
    """A StageTimer over 3 'env' and 2 'grad' stages on the fake clock."""
    _fake_clock(monkeypatch)
    timer = prof.StageTimer()
    for _ in range(3):
        with timer.stage("env", block_on=block_on):
            pass
    for _ in range(2):
        with timer.stage("grad"):
            pass
    return timer.summary({"env": 64, "other": 1})


def test_stage_timer_and_throughput_equal_jax(monkeypatch):
    """StageTimer.summary (JAX's keys: total_s, calls, mean_s, throughput
    where units are given) equals JAX's exactly under the same clock
    readings."""
    want = _timed(jprof, jnp.ones(3), monkeypatch)
    got = _timed(pprof, {"x": [torch.ones(3)]}, monkeypatch)
    assert got == want
    assert set(got["env"]) == {"total_s", "calls", "mean_s", "throughput"}
    assert set(got["grad"]) == {"total_s", "calls", "mean_s"}


def test_trace_writes_a_file(tmp_path):
    """trace yields its directory and leaves a Chrome trace file there that
    holds the traced work."""
    log_dir = str(tmp_path / "trace")
    with pprof.trace(log_dir) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == log_dir
    files = list(pathlib.Path(log_dir).glob("trace_*.json"))
    assert len(files) == 1 and "aten::mm" in files[0].read_text()


def test_synchronize_walks_trees():
    """block_on may be a tensor, a tree of them, or hold other leaves; CPU
    tensors need no synchronisation."""
    pprof.synchronize(torch.ones(2))
    pprof.synchronize({"a": [torch.ones(2), None], "b": (1, torch.zeros(1))})


def test_full_registration_registers_the_port():
    """full_registration (JAX's alias of register_gym_envs) registers every
    tarware id to the port's gym adapter; in a fresh interpreter, since the
    two packages' registrations are mutually exclusive in one process."""
    code = (
        "import gymnasium as gym\n"
        "import swarm_ode_tpu_torch as port\n"
        "port.full_registration()\n"
        "port.full_registration()\n"
        "for i in ('tarware-tiny-3agvs-2pickers-partialobs-v1',\n"
        "          'tarware-extralarge-19agvs-9pickers-globalobs-v1'):\n"
        "    assert gym.spec(i).entry_point == 'swarm_ode_tpu_torch.env.gym_adapter:Warehouse'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
