"""Behaviour cloning, DAgger and clone evaluation in the port against the JAX
package's train/train_bc.py, on one small HDF5 dataset that JAX's
collect_data writes once for the module (tiny, 4 episodes of 40 steps):
load_decision_arrays bit for bit; train_bc for 2 epochs from the same
initial parameters with the same split and epoch orders (numpy's, recorded
call by call, bit for bit), the per-epoch losses and accuracies and the
best parameters within 1e-5 (JAX at HIGHEST); collect_dagger on JAX's own
draws (argmax, coordinated, and sampled at T > 0 with its Gumbels and beta
coins) with the observations, expert labels and busy flags bit for bit;
evaluate_policy's stats; the checkpoint written, read back bit for bit;
and run_marl(init_q_from=...) for IQL and QMIX starting from the clone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swarm_ode_tpu.config import EnvConfig as JEnvConfig
from swarm_ode_tpu.data.collect import collect_data as jcollect_data
from swarm_ode_tpu.train import train_bc as jbc
from swarm_ode_tpu_torch import convert
from swarm_ode_tpu_torch.train import run_rl
from swarm_ode_tpu_torch.train import train_bc as pbc
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager
from torch_port_helpers import TINY, both, fields, jax_agent, jax_example_graph, jax_noise

HIGHEST = jax.default_matmul_precision("highest")
STEPS = 40


def _short(orig):
    return staticmethod(lambda env_id, **o: orig(env_id, **{"max_steps": STEPS, **o}))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The dataset file (JAX's collect_data), JAX's and the port's tiny
    params and layouts at 40-step episodes, and a gnn clone's initial
    parameters (JAX's, and the port's copy)."""
    path = str(tmp_path_factory.mktemp("bc") / "tiny.h5")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JEnvConfig, "from_env_id", _short(JEnvConfig.from_env_id))
        jcollect_data(TINY, 4, 0, out_path=path, batch=4, chunk=STEPS, verbose=False)
    jp, jl, pp, pl = both(TINY, max_steps=STEPS)
    cfg = run_rl.RLRunConfig(env_id=TINY, net="gnn", hidden_dim=8, device="cpu")
    _, jnet = jax_agent(cfg, jp)
    jinit = jnet.init(jax.random.PRNGKey(1), jax_example_graph(jp, jax.random.PRNGKey(2)))
    pinit = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jinit), "cpu")
    _, pnet = run_rl.make_agent(cfg, pp)
    return {"path": path, "jp": jp, "jl": jl, "pp": pp, "pl": pl, "jnet": jnet, "pnet": pnet,
            "jinit": jinit, "pinit": pinit}


def test_load_decision_arrays_matches_jax(setup):
    want = jbc.load_decision_arrays([setup["path"]], stride=2)
    got = pbc.load_decision_arrays([setup["path"]], stride=2)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape == (4 * STEPS // 2, 5, 119)


class _RecordingRng:
    """np.random.default_rng whose permutations are recorded."""

    def __init__(self, log, seed):
        self.rng, self.log = np.random.Generator(np.random.PCG64(seed)), log

    def permutation(self, x):
        out = self.rng.permutation(x)
        self.log.append(np.array(out))
        return out


BC = dict(env_id=TINY, net="gnn", hidden_dim=8, lr=3e-3, epochs=2, batch_size=8,
          val_frac=0.25, step_stride=2, seed=3)


def test_train_bc_matches_jax_and_checkpoints(setup, tmp_path, monkeypatch):
    arrays = jbc.load_decision_arrays([setup["path"]], stride=2)
    orders = {"jax": [], "port": []}
    for side, mod in (("jax", jbc), ("port", pbc)):
        monkeypatch.setattr(mod.np.random, "default_rng",
                            lambda seed, log=orders[side]: _RecordingRng(log, seed))
        if side == "jax":
            with HIGHEST:
                # A copy: JAX's epoch donates the parameters it is given.
                jout = jbc.train_bc(jbc.BCConfig(**BC), verbose=False, arrays=arrays,
                                    init_params=jax.tree.map(jnp.array, setup["jinit"]))
        else:
            pout = pbc.train_bc(pbc.BCConfig(**BC, checkpoint_dir=str(tmp_path), device="cpu"),
                                verbose=False, arrays=arrays, init_params=setup["pinit"])
    # The split's episode order, then each train epoch's row order.
    assert len(orders["port"]) == len(orders["jax"]) == 3
    for j, p in zip(orders["jax"], orders["port"]):
        assert np.array_equal(p, j)
    for jh, ph in zip(jout["history"], pout["history"]):
        for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
            np.testing.assert_allclose(ph[k], jh[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert pout["best_val_loss"] == min(h["val_loss"] for h in pout["history"])
    want = convert.flax_params_to_state_dict(jax.tree.map(np.asarray, jout["params"]), "cpu")
    scale = max(float(v.abs().max()) for v in want.values())
    for name, w in want.items():
        assert float((pout["params"][name] - w).abs().max()) <= 1e-5 * scale, name
    # The best epoch's checkpoint, read back bit for bit.
    best = int(np.argmin([h["val_loss"] for h in pout["history"]]))
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() == best
    restored = ck.restore({"q_params": setup["pinit"]})["q_params"]
    assert all(torch.equal(restored[k], v) for k, v in pout["params"].items())


class _JaxRolloutDraws:
    """The draws of JAX's collect_dagger / evaluate_policy from their key, in
    their split order: kr, key = split(key) (resets per split(kr, E)); the
    step keys split(key, steps); at step t, k, kc = split(key_t) for DAgger
    (the clone's Gumbels per split(kc, E), the beta coins uniform(k, (E,)))
    and the Gumbels per split(key_t, E) for evaluation; the env's draws from
    the envs' own state keys."""

    def __init__(self, jp, key, steps, dagger):
        self.jp, self.dagger, self.t = jp, dagger, 0
        self.kr, key = jax.random.split(key)
        self.step_keys = jax.random.split(key, steps)
        A, n = jp.num_agents, jp.num_actions
        self._gumbel = jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, (A, n))))

    def reset(self, E):
        from swarm_ode_tpu.env import step as jstep

        js = jax.jit(jax.vmap(lambda k: jstep.reset(self.jp, k)))(jax.random.split(self.kr, E))
        self.env_keys = js.key
        return convert.env_state_from_numpy(fields(js), device="cpu")

    def step(self, E):
        noise, self.env_keys = jax_noise(self.jp, self.env_keys)
        if not self.dagger:
            self.t += 1
        return noise

    def gumbel(self, E):
        k = self.step_keys[self.t]
        if self.dagger:
            k = jax.random.split(k)[1]
        return torch.from_numpy(np.array(self._gumbel(jax.random.split(k, E))))

    def coin(self, E):
        k = jax.random.split(self.step_keys[self.t])[0]
        self.t += 1
        return torch.from_numpy(np.array(jax.random.uniform(k, (E,))))


DAGGER_CASES = [dict(coordinated=False), dict(coordinated=True), dict(temperature=1.5)]


@pytest.mark.parametrize("case", DAGGER_CASES, ids=["argmax", "coordinated", "sampled"])
def test_collect_dagger_matches_jax(setup, case):
    s = setup
    key = jax.random.PRNGKey(6)
    kw = dict(beta=0.5, coordinated=case.get("coordinated", True),
              temperature=case.get("temperature", 0.0), steps=20)
    with HIGHEST:
        want = jbc.collect_dagger(s["jp"], s["jl"], s["jnet"], s["jinit"], 2, key, **kw)
    got = pbc.collect_dagger(s["pp"], s["pl"], s["pnet"], s["pinit"], 2,
                             _JaxRolloutDraws(s["jp"], key, 20, dagger=True), **kw)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.view(np.uint16) if g.dtype == np.float16 else g,
                              w.view(np.uint16) if w.dtype == np.float16 else w)
    assert got[1].shape == (40, 5) and got[2].any() and not got[2].all()


def test_evaluate_policy_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(9)
    with HIGHEST:
        want = jbc.evaluate_policy(s["jp"], s["jnet"], s["jinit"], 2, key, coordinated=True,
                                   verbose=False)
    got = pbc.evaluate_policy(s["pp"], s["pnet"], s["pinit"], 2,
                              _JaxRolloutDraws(s["jp"], key, STEPS, dagger=False),
                              coordinated=True, verbose=False)
    for k in ("episodes", "pick_rate", "deliveries", "clashes", "coordinated", "temperature"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["return"], want["return"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("algo", ["iql", "qmix"])
def test_init_q_from_loads_the_clone(setup, tmp_path, algo):
    """run_marl's agent warm-started from a clone's checkpoint: the Q-network's
    parameters and their targets equal the clone's, the rest as initialised."""
    CheckpointManager(str(tmp_path)).save(0, {"q_params": setup["pinit"]})
    cfg = run_rl.RLRunConfig(env_id=TINY, algo=algo, net="gnn", num_envs=2, hidden_dim=8,
                             init_q_from=str(tmp_path), device="cpu")
    fresh = run_rl.MarlRun(dataclasses.replace(cfg, init_q_from=None)).astate
    st = run_rl.MarlRun(cfg).astate
    prefix = "q." if algo == "qmix" else ""
    for name, v in setup["pinit"].items():
        assert torch.equal(st.params[prefix + name], v), name
        assert torch.equal(st.target_params[prefix + name], v), name
    assert set(st.params) == set(fresh.params)
    for name, v in fresh.params.items():
        if name.startswith("mixer."):  # QMIX's mixer stays as initialised
            assert torch.equal(st.params[name], v), name
    with pytest.raises(FileNotFoundError):
        run_rl.MarlRun(dataclasses.replace(cfg, init_q_from=str(tmp_path / "none")))
    with pytest.raises(ValueError, match="init_q_from supports"):
        run_rl.MarlRun(dataclasses.replace(cfg, algo="coma"))
