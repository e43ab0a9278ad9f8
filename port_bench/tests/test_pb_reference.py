"""The plain references against the program's CPU path at tiny sizes: the
env and dispatcher field for field, the window cut exactly, the GDE's
predictions, loss and gradients to float32 rounding."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from port_bench import corpus
from port_bench.reference import gde as ref
from port_bench.reference.tarware import config as rconfig
from port_bench.reference.tarware import heuristic as rheuristic
from port_bench.reference.tarware import layout as rlayout
from port_bench.reference.tarware import state as rstate
from port_bench.reference.tarware import step as rstep
from port_bench.reference.tarware.bfs import compaction_rows


ROLLOUTS = [
    ("tarware-tiny-3agvs-2pickers-partialobs-v1", 128, 30),
    ("tarware-medium-19agvs-9pickers-partialobs-v1", 12, 40),
    ("tarware-large-15agvs-8pickers-partialobs-v1", 12, 30),
]


def _rollouts(env_id, B, steps, low=0):
    """The program's rollout and the reference's from the same resets and
    draws, the reference answering every row of the first `low` envs."""
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import EnvState, make_params
    from swarm_ode_tpu_torch.env.step import StepNoise
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    rcfg = rconfig.EnvConfig.from_env_id(env_id)
    rlay = rlayout.build_layout(rcfg)
    rp = rstate.make_params(rcfg, rlay, device="cpu")
    gen = torch.Generator().manual_seed(11)
    s0 = rstep.reset(rp, B, gen)
    draws = [rstep.draw_noise(rp, B, gen) for _ in range(steps)]
    cfg = EnvConfig.from_env_id(env_id)
    lay = build_layout(cfg)
    got = heuristic_rollout(make_params(cfg, lay, device="cpu"), lay, B, steps,
                            state=EnvState(**{f.name: getattr(s0, f.name).clone()
                                              for f in dataclasses.fields(s0)}),
                            noise=[StepNoise(n.break_r, n.delivery_gumbel) for n in draws])
    every_row = torch.arange(B) < low
    want = rheuristic.heuristic_rollout(dataclasses.replace(rp, every_row=every_row), rlay, B,
                                        steps, state=s0, noise=draws)
    first = -(-compaction_rows(B, rp.num_agents, rp.replan_row_frac) // rp.num_agents)
    assert low < first < B
    return got, want, first


def _assert_equal_at(got, want, envs):
    for part in ("state", "heuristic"):
        for f in dataclasses.fields(getattr(want, part)):
            a, b = getattr(getattr(got, part), f.name), getattr(getattr(want, part), f.name)
            assert torch.equal(a[envs], b[envs]), (part, f.name)
    for k in ("deliveries", "clashes", "stucks", "replan_overflow"):
        assert torch.equal(getattr(got, k)[envs], getattr(want, k)[envs]), k
    assert int(got.replan_overflow.sum()) == 0


@pytest.mark.parametrize("env_id,B,steps", ROLLOUTS)
def test_rollout_equals_the_program_past_the_compacted_block(env_id, B, steps):
    got, want, first = _rollouts(env_id, B, steps)
    _assert_equal_at(got, want, slice(first, None))


@pytest.mark.parametrize("env_id,B,steps", ROLLOUTS)
def test_rollout_with_every_row_equals_the_program_at_the_batch_start(env_id, B, steps):
    """The first envs, whose rows all fall among the K the compacted query
    runs while the batch's needed rows leave room, against the reference's
    `every_row` rule."""
    low = 4 if B > 64 else 1
    got, want, _ = _rollouts(env_id, B, steps, low)
    _assert_equal_at(got, want, slice(0, low))


def _tiny_gde(horizon=4):
    from swarm_ode_tpu_torch.models.gde import GraphODE

    gen = torch.Generator().manual_seed(3)
    data = corpus.make_corpus(3, 20, 28, 435, 19, (25, 22), horizon, 0.05, gen, "cpu")
    weights = corpus.make_weights(435, 64, gen, "cpu")
    model = GraphODE(node_dim=435, num_agvs=19, num_pickers=9, hidden_dim=64)
    model.load_state_dict(weights)
    pairs = torch.tensor([[0, 0], [1, 2], [2, 7], [0, 18], [1, 3], [2, 15]], dtype=torch.int32)
    return data, weights, model, pairs


def test_window_cut_equals_the_trainers():
    from swarm_ode_tpu_torch.train.train_gde import window_batch

    data, _, _, pairs = _tiny_gde()
    got = window_batch(data, pairs, 5, horizon=4, true_len=20)
    obs, count, next_pos, hweight = ref.cut_windows(data["episodes"], data["positions"], pairs,
                                                    5, 4, 20)
    assert torch.equal(got["obs"], obs) and torch.equal(got["count"].long(), count)
    assert torch.equal(got["next_pos"], next_pos) and torch.equal(got["hweight"], hweight)


def test_predictions_equal_the_servers():
    from swarm_ode_tpu_torch.serving import make_gde_fn

    data, weights, model, pairs = _tiny_gde()
    obs, count, _, _ = ref.cut_windows(data["episodes"], data["positions"], pairs, 5, 4, 20)
    got = make_gde_fn(model, distance_threshold=5.0, horizon=4)(obs, count.to(torch.int32))
    w = {k: v.double() for k, v in weights.items()}
    want = ref.newest(ref.trajectories(w, obs.double(), count, 19, 5.0, 4), count)
    assert got.shape == want.shape == (6, 5, 28, 2)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_loss_and_gradients_equal_the_trainers():
    from swarm_ode_tpu_torch.train.train_gde import _batch_loss, window_batch

    data, weights, model, pairs = _tiny_gde()
    hw = (3.0, 1.0, 1.0, 1.0)
    loss = _batch_loss(model, 19, 5.0, horizon=4, horizon_weights=hw)(
        window_batch(data, pairs, 5, horizon=4, true_len=20))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    names = [n for n, _ in model.named_parameters()]
    leaves = [weights[n].double().requires_grad_() for n in names]
    obs, count, next_pos, hweight = ref.cut_windows(data["episodes"], data["positions"], pairs,
                                                    5, 4, 20, torch.float64)
    want = ref.window_losses(dict(zip(names, leaves)), obs, count, next_pos, hweight, hw, 19,
                             5.0).mean()
    wgrads = torch.autograd.grad(want, leaves)
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    for g, r in zip(grads, wgrads):
        assert float((g.double() - r).abs().max()) <= 1e-5 * float(r.abs().max()) + 1e-12
