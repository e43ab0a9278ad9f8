"""The harness finds every cell's files by name, prints the contract's keys,
refuses to report with jax or the JAX package loaded, and takes a new cell,
traffic mix and metric as files alone."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.tests import helpers

BENCH = json.loads((helpers.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(helpers.REPO, workload)
    assert cell.config["env_id"].startswith("tarware-")
    harness.runner_of(cell)
    for m in cell.per_layer:
        assert callable(harness.load_module(harness.reader_path(
            cell.root, cell.bench, m["name"])).read)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert all(m["moves"] in names for m in cell.per_layer)


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (helpers.REPO / c["file"]).is_file() and c["file"].startswith("port_bench/")
        assert json.loads((helpers.REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("modules,found", [
    (["swarm_ode_tpu_torch", "swarm_ode_tpu_torch.env.step", "numpy", "jaxtyping"], []),
    (["swarm_ode_tpu.env.step", "torch"], ["swarm_ode_tpu.env.step"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
])
def test_forbidden_modules_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_modules(modules) == found


def test_the_harness_and_its_reference_load_no_jax():
    code = ("import sys; from port_bench import harness, run, counts, tracing, corpus; "
            "from port_bench.reference import gde; from port_bench.reference.tarware import "
            "heuristic; from port_bench.runners import rollout, gde_train, gde_serve; "
            "print(harness.forbidden_modules()); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'swarm_ode_tpu_torch'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=helpers.REPO, capture_output=True,
                         text=True, check=True).stdout.splitlines()
    assert out == ["[]", "[]"]


def test_result_line_keys_and_checks_last(tmp_path):
    root = helpers.tiny_root(tmp_path)
    res = helpers.run(root, "rollout.medium_19x9")
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["correct"] is True and res["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """The runner exits non-zero and prints no result: here for want of a
    card, and in a directory holding only the benchmark's files."""
    only = tmp_path / "only"
    only.mkdir()
    shutil.copy(helpers.REPO / "BENCHMARK.json", only)
    shutil.copytree(helpers.PB, only / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    for cwd in (helpers.REPO, only):
        proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                               "rollout.medium_19x9", "--seed", "1", "--seconds", "1"],
                              cwd=cwd, capture_output=True, text=True, env=env)
        assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_dotted_metric_falls_back_to_its_first_parts_reader(tmp_path):
    metrics = tmp_path / "b" / "metrics"
    metrics.mkdir(parents=True)
    for name in ("x.py", "x.special.py"):
        (metrics / name).write_text("def read(m):\n    return 1\n")
    bench = {"paths": ["a", "b"]}
    assert harness.reader_path(tmp_path, bench, "x.other").name == "x.py"
    assert harness.reader_path(tmp_path, bench, "x.special").name == "x.special.py"
    with pytest.raises(FileNotFoundError):
        harness.reader_path(tmp_path, bench, "y.other")


NEW_METRIC = '''"""Episodes' worth of steps in the traced slice (a throwaway metric)."""


def read(m):
    return m.counters["steps"] / 500
'''


def test_a_new_cell_mix_and_metric_are_files_alone(tmp_path):
    """A traffic mix and a per-layer metric that exist only in the test's
    directory, and a cell that uses them, run through the harness without a
    change to any file of the benchmark."""
    root = helpers.tiny_root(tmp_path)
    extra = root / "extra"
    (extra / "traffic").mkdir(parents=True)
    (extra / "metrics").mkdir()
    mix = helpers.traffic("rollout", batch=12, steps=15, sample_envs=4)
    (extra / "traffic" / "rollout_small.json").write_text(json.dumps(mix))
    (extra / "metrics" / "traced_share.rollout_small.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["paths"].append("extra")
    bench["workloads"].append({"name": "rollout_small.large_15x8", "config": "large_15x8",
                               "traffic": "rollout_small", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "traced_share.rollout_small", "unit": "episodes",
                               "better": "higher", "source": "program_counter",
                               "layer": "dispatcher and env step", "moves": "env_steps_per_s",
                               "workloads": ["rollout_small.large_15x8"]})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("rollout_small.large_15x8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in helpers.PB.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    res = helpers.run(root, "rollout_small.large_15x8", trace=True)
    assert res["correct"] is True
    assert res["metrics"]["traced_share.rollout_small"]["value"] == pytest.approx(2 / 500)
    assert "launches_per_step.rollout" not in res["metrics"]
    assert before == {p: p.read_bytes() for p in helpers.PB.rglob("*") if p.is_file()
                      and "__pycache__" not in p.parts}
