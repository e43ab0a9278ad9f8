"""The port's command lines against the JAX package's scripts, on the CPU:
`python -m swarm_ode_tpu_torch.policies.heuristic run | parity | render`
(scripts/run_heuristic.py, eval_parity.py, render_episode.py) and
`python -m swarm_ode_tpu_torch.data.dataset build-cache`
(scripts/build_obs_cache.py). The episodes start from JAX's resets and take
JAX's draws; the scripts' own formatting code is read out of them (ast) and
run on the same numbers."""
import ast
import dataclasses
import io
import json
import pathlib
import runpy
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from swarm_ode_tpu.config import EnvConfig as JEnvConfig
from swarm_ode_tpu.data.dataset import TrajectoryDataset as JTrajectoryDataset
from swarm_ode_tpu.env import step as jstep
from swarm_ode_tpu.env.env import rollout as jrollout
from swarm_ode_tpu.policies import heuristic as jheur
from swarm_ode_tpu.utils.metrics import pick_rate as jpick_rate
from swarm_ode_tpu.utils.metrics import summarize_traj as jsummarize
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.config import EnvConfig as PEnvConfig
from swarm_ode_tpu_torch.data import dataset as pdataset
from swarm_ode_tpu_torch.policies import heuristic as pheur
from swarm_ode_tpu_torch.utils.metrics import summarize_traj
from torch_port_helpers import TINY, both, fields, jax_noise, jax_reset_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
FIXTURE = (REPO / "tests" / "fixtures" / "datasets"
           / "warehouse_data_tarware-tiny-3agvs-2pickers-partialobs-v1_seed0.h5")
B, T, SEED = 4, 60, 5


def _script_main_block(name: str):
    """The statements under a script's `if __name__ == "__main__":`."""
    tree = ast.parse((SCRIPTS / name).read_text())
    for node in tree.body:
        if isinstance(node, ast.If) and "__main__" in ast.unparse(node.test):
            return node.body
    raise AssertionError(f"{name} has no __main__ block")


def _script_constant(name: str, const: str):
    tree = ast.parse((SCRIPTS / name).read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == const for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{name} has no {const}")


def _script_function(name: str, fn: str):
    tree = ast.parse((SCRIPTS / name).read_text())
    return next(n.body for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn)


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, layout, port params, layout), B JAX resets of tiny and
    T steps of the JAX step's draws from their keys."""
    jp, jl, pp, pl = both(TINY)
    js0 = jax_reset_batch(jp, B, SEED)
    noise, keys = [], js0.key
    for _ in range(T):
        n, keys = jax_noise(jp, keys)
        noise.append(n)
    return jp, jl, pp, pl, js0, noise


def _env(js0, noise, b: int):
    """Env b's reset state and draws for the port (B = 1)."""
    state = convert.env_state_from_numpy(fields(jax.tree.map(lambda x: x[b:b + 1], js0)),
                                         device="cpu")
    return state, [dataclasses.replace(n, **{f.name: getattr(n, f.name)[b:b + 1]
                                             for f in dataclasses.fields(n)}) for n in noise]


# --- run -------------------------------------------------------------------

def test_run_episode_summary_equals_jax(tiny):
    """run's core from JAX's reset with JAX's draws: summarize_traj of the
    episode equals JAX's summarize_traj of its `rollout` (run_heuristic.py's
    run_episode), integers exact and the return within 1e-5."""
    jp, jl, pp, pl, js0, noise = tiny
    policy = jheur.make_policy(jp, jl)
    jax_episode = jax.jit(lambda es: jrollout(jp, policy, jheur.init_state(jp), es, T)[2])
    for b in (0, 1):
        rewards, _, info = jax.tree.map(np.asarray,
                                        jax_episode(jax.tree.map(lambda x: x[b], js0)))
        want = jsummarize(rewards, info)
        state, nz = _env(js0, noise, b)
        got = summarize_traj(*pheur.run_episode(pp, pl, T, state=state, noise=nz))
        assert got.keys() == want.keys()
        for k, w in want.items():
            if k == "global_episode_return":
                np.testing.assert_allclose(got[k], w, rtol=1e-5)
            elif k == "episode_returns":
                np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6)
            else:
                assert got[k] == w and type(got[k]) is type(w), k
        assert want["total_deliveries"] > 0


def test_stat_line_is_run_heuristics_format():
    """The stat line is the one run_heuristic.py's f-string (:60-67) prints
    for the same summary and seconds, character for character, and
    STAT_LINE reads its fields back."""
    fstring = next(
        n for n in ast.walk(ast.Module(body=_script_function("run_heuristic.py", "main"),
                                       type_ignores=[]))
        if isinstance(n, ast.JoinedStr) and "Episode" in ast.unparse(n))
    jax_line = ast.Expression(body=fstring)
    s = {"overall_pick_rate": 115.97123, "global_episode_return": -3.25,
         "total_deliveries": 81, "total_clashes": 170, "total_stuck": 0, "episode_length": 500}
    for ep, start, end in ((0, 1.0, 3.5), (12, 0.0, 0.123)):
        want = eval(compile(jax_line, "run_heuristic.py", "eval"),
                    {"ep": ep, "s": s, "start": start, "end": end})
        got = pheur.stat_line(ep, s, end - start)
        assert got == want
        m = pheur.STAT_LINE.match(got)
        assert m is not None and int(m.group("episode")) == ep
        values = dict(zip(pheur.STAT_FIELDS, map(float, m.groups()[1:])))
        assert values["total_deliveries"] == 81.0
        assert values["fps"] == pytest.approx(500 / (end - start), abs=0.005)


def _short_episodes(monkeypatch, steps: int):
    """EnvConfig.from_env_id with episodes of `steps` steps (the CLIs run
    the config's max_steps)."""
    real = PEnvConfig.from_env_id
    monkeypatch.setattr(PEnvConfig, "from_env_id",
                        staticmethod(lambda env_id, **kw: real(env_id, max_steps=steps, **kw)))


def test_run_cli_prints_each_seeded_episode(monkeypatch, capsys):
    """`run` prints one stat line an episode, episode ep from a generator
    seeded seed + ep, and returns each summary with its overflow."""
    _short_episodes(monkeypatch, 20)
    _, _, pp, pl = both(TINY)
    got = pheur.main(["run", "--num_episodes", "2", "--seed", "7", "--env_id", TINY,
                      "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and len(got) == 2
    for ep, (line, s) in enumerate(zip(lines, got)):
        m = pheur.STAT_LINE.match(line)
        assert m is not None and int(m.group("episode")) == ep
        want = summarize_traj(*pheur.run_episode(pp, pl, 20, torch.Generator().manual_seed(7 + ep)))
        assert s["episode_length"] == 20 and s["replan_overflow"] == 0
        for k in ("total_deliveries", "total_clashes", "total_stuck", "global_episode_return"):
            assert s[k] == want[k]
        assert line == pheur.stat_line(ep, s, s["seconds"])


# --- parity ----------------------------------------------------------------

def _jax_one(jp, jl, steps):
    """eval_parity.py's `one` (:70-83), from a reset state."""
    policy = jheur.make_policy(jp, jl)

    def one(es):
        h = jheur.init_state(jp)

        def body(carry, _):
            es, h = carry
            a, h = policy(jp, es, h)
            es, rew, done, info = jstep.step(jp, es, a)
            return (es, h), (rew.sum(), info["shelf_deliveries"],
                             info["clashes"], info["stucks"])

        (es, h), out = jax.lax.scan(body, (es, h), None, length=steps)
        return tuple(o.sum() for o in out)

    return jax.jit(jax.vmap(one))


def test_parity_totals_equal_jax_one(tiny):
    """parity's per-env sums over one batched rollout of B envs equal
    eval_parity.py's `one` on the same resets and draws: counts exact, the
    return within 1e-5."""
    jp, jl, pp, pl, js0, noise = tiny
    ret, deliv, clash, stuck = map(np.asarray, _jax_one(jp, jl, T)(js0))
    state = convert.env_state_from_numpy(fields(js0), device="cpu")
    got = pheur.parity_totals(pp, pl, B, T, state=state, noise=noise)
    np.testing.assert_array_equal(got["total_deliveries"], deliv)
    np.testing.assert_array_equal(got["total_clashes"], clash)
    np.testing.assert_array_equal(got["total_stuck"], stuck)
    np.testing.assert_allclose(got["global_episode_return"], ret, rtol=1e-5)
    assert got["global_episode_return"].dtype == np.float32
    assert (got["replan_overflow"] == 0).all() and deliv.sum() > 0


def test_parity_reference_is_the_scripts():
    assert pheur.PARITY_REFERENCE == _script_constant("eval_parity.py", "REFERENCE")


def _jax_report(totals, steps):
    """eval_parity.py's own report code (from `ours = ...` to its JSON
    line) run on these sums: (printed lines, the JSON line's object)."""
    body = _script_main_block("eval_parity.py")
    start = next(i for i, n in enumerate(body)
                 if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "ours")
    printed = []
    scope = {"np": np, "json": json, "pick_rate": jpick_rate, "steps": steps,
             "REFERENCE": _script_constant("eval_parity.py", "REFERENCE"),
             "ret": totals["global_episode_return"], "deliv": totals["total_deliveries"],
             "clash": totals["total_clashes"], "stuck": totals["total_stuck"],
             "print": lambda *a: printed.append(" ".join(map(str, a)))}
    exec(compile(ast.Module(body=body[start:], type_ignores=[]), "eval_parity.py", "exec"),
         scope)
    return printed[:-1], json.loads(printed[-1])


def test_parity_report_is_eval_paritys(tiny):
    """The table and the JSON `detail` equal what eval_parity.py's code
    prints for the same sums."""
    jp, jl, pp, pl, js0, noise = tiny
    state = convert.env_state_from_numpy(fields(js0), device="cpu")
    totals = pheur.parity_totals(pp, pl, B, T, state=state, noise=noise)
    want_lines, want_json = _jax_report(totals, T)
    lines, report = pheur.parity_report(totals, T)
    assert lines == want_lines
    assert want_json == {"metric": "parity_medium_30ep", "detail": report}
    assert json.loads(json.dumps(report)) == report


@pytest.mark.parametrize("argv", [[], ["--replan_rejoin"], ["--row_frac", "0.5"],
                                  ["--replan_rejoin", "--row_frac", "1.0"]])
def test_parity_overrides_equal_jaxs(argv, monkeypatch):
    """--replan_rejoin / --row_frac, parsed by `parity`'s parser, give the
    EnvConfig that eval_parity.py's parser and overrides (:55-64) give,
    field for field."""
    body = _script_main_block("eval_parity.py")
    parser = runpy.run_path(str(SCRIPTS / "eval_parity.py"), run_name="eval_parity")["p"]
    args = parser.parse_args(argv)
    parsed = []
    monkeypatch.setattr(pheur, "_parity", parsed.append)
    pheur.main(["parity", *argv])
    first = next(i for i, n in enumerate(body)
                 if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "cfg")
    scope = {"args": args, "EnvConfig": JEnvConfig}
    exec(compile(ast.Module(body=body[first:first + 2], type_ignores=[]), "eval_parity.py",
                 "exec"), scope)
    (ours,) = parsed
    got = pheur.parity_config(ours.env_id, ours.replan_rejoin, ours.row_frac)
    assert dataclasses.asdict(got) == dataclasses.asdict(scope["cfg"])


def test_parity_cli_prints_the_table_and_json(monkeypatch, capsys):
    """`parity` runs `--episodes` envs from a generator seeded `--seed`,
    prints parity_report's table and the JSON line, and returns the sums."""
    _short_episodes(monkeypatch, 20)
    _, _, pp, pl = both(TINY)
    got = pheur.main(["parity", "--env_id", TINY, "--episodes", "3", "--seed", "4",
                      "--device", "cpu"])
    want = pheur.parity_totals(pp, pl, 3, 20, torch.Generator().manual_seed(4))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    lines, report = pheur.parity_report(want, 20)
    out = capsys.readouterr().out.splitlines()
    assert out[:-1] == lines
    assert json.loads(out[-1]) == {"metric": "parity_medium_30ep", "detail": report}


# --- render ----------------------------------------------------------------

def test_render_cli_writes_the_gif(tmp_path, capsys):
    out = tmp_path / "episode.gif"
    n = pheur.main(["render", "--steps", "6", "--every", "2", "--out", str(out),
                    "--device", "cpu"])
    assert n == 3 and capsys.readouterr().out.strip() == f"wrote {out} (3 frames)"
    with Image.open(out) as gif:
        assert gif.n_frames == 3


def test_render_frames_start_from_jaxs_frame(tiny):
    """From JAX's reset over 6 steps, every 2: 3 frames, the first equal to
    JAX's render_state of that state."""
    from swarm_ode_tpu.env.rendering import render_state as jrender

    jp, jl, pp, pl, js0, noise = tiny
    state, nz = _env(js0, noise, 0)
    frames = pheur.render_episode(pp, pl, 6, every=2, state=state, noise=nz)
    assert len(frames) == 3
    want = jrender(jp, jl, jax.tree.map(lambda x: x[0], js0), mode="rgb_array")
    np.testing.assert_array_equal(frames[0], want)
    assert not np.array_equal(frames[2], frames[0])


def test_render_without_pil_raises(monkeypatch, tmp_path):
    """Without PIL, `render` fails with an ImportError naming it, before it
    steps an env or writes a file."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        pheur.main(["render", "--out", str(tmp_path / "x.gif"), "--device", "cpu"])
    assert not (tmp_path / "x.gif").exists()


# --- build-cache -----------------------------------------------------------

def test_build_cache_sidecars_equal_jaxs(tmp_path, capsys):
    """The port's build-cache and JAX's _load_file(cache=True) (what
    scripts/build_obs_cache.py calls) write the same sidecar from two copies
    of one file: the .obscache.npy byte for byte, the meta's offsets and
    agent counts equal. Built in tmp_path, never under tests/fixtures."""
    a, b = tmp_path / "jax" / FIXTURE.name, tmp_path / "port" / FIXTURE.name
    for p in (a, b):
        p.parent.mkdir()
        shutil.copy2(FIXTURE, p)
    JTrajectoryDataset._load_file(str(a), cache=True)
    pdataset.main(["build-cache", str(tmp_path / "port" / "*.h5")])
    out = capsys.readouterr().out.strip()
    assert out.startswith(f"{b}: 4 episodes, 3+2 agents, ") and out.endswith("s")
    side = lambda p, ext: pathlib.Path(str(p) + ext)  # noqa: E731
    assert side(b, ".obscache.npy").read_bytes() == side(a, ".obscache.npy").read_bytes()
    ma, mb = np.load(side(a, ".obscachemeta.npz")), np.load(side(b, ".obscachemeta.npz"))
    assert sorted(ma.files) == sorted(mb.files)
    for k in ("offsets", "num_agvs", "num_pickers", "src_mtime"):
        np.testing.assert_array_equal(mb[k], ma[k])


def test_build_cache_default_glob(tmp_path, monkeypatch, capsys):
    """With no globs, build-cache takes datasets/*.h5 under the working
    directory."""
    (tmp_path / "datasets").mkdir()
    shutil.copy2(FIXTURE, tmp_path / "datasets" / FIXTURE.name)
    monkeypatch.chdir(tmp_path)
    pdataset.main(["build-cache"])
    assert capsys.readouterr().out.startswith(f"datasets/{FIXTURE.name}: 4 episodes")
    assert (tmp_path / "datasets" / (FIXTURE.name + ".obscache.npy")).exists()


# --- the card by default -----------------------------------------------------

@pytest.mark.parametrize("argv", [["run", "--num_episodes", "1"], ["parity", "--episodes", "2"],
                                  ["render", "--steps", "2"]])
def test_clis_run_on_the_card_by_default(argv, tmp_path, monkeypatch):
    """Without --device the commands take the card; with no card they raise
    before any work rather than run on the CPU (decided here, when the test
    runs)."""
    monkeypatch.chdir(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there (chip_smoke.py)")
    stdout = io.StringIO()
    monkeypatch.setattr(sys, "stdout", stdout)
    with pytest.raises(RuntimeError, match="card"):
        pheur.main(argv)
    assert stdout.getvalue() == "" and not list(tmp_path.iterdir())
