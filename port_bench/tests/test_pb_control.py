"""The control, the reference in the next lower precision put in the
program's place, comes out not correct: on the CPU at a tiny size (TF32
emulated by rounding every product's operands; the rollout's draws in
bfloat16), and on a card, where one is, with the card's own TF32."""
from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.tests import helpers

CELLS = {"rollout.medium_19x9": {"rollout": {"steps": 150, "sample_envs": 10}},
         "gde_train.medium_19x9": {},
         "gde_serve.medium_19x9": {}}


def _control(root, workload, device):
    cell = harness.load_cell(root, workload)
    ctx = harness.Context(cell, 2**31 + 99, 0.5, False, device=device, log=lambda m: None)
    drv = harness.runner_of(cell)
    st = drv.setup(ctx)
    drv.window(ctx, st)
    drv.release(st)
    program = {k: v for k, (v, _) in drv.judge(ctx, st).items()}
    return program, drv.control(ctx, st), cell.traffic["limits"]


@pytest.mark.parametrize("workload", list(CELLS))
def test_control_fails_on_the_cpu(tmp_path, workload):
    program, control, limits = _control(helpers.tiny_root(tmp_path, **CELLS[workload]),
                                        workload, "cpu")
    assert all(program[k] <= limits[k] for k in program), program
    assert any(control[k] > limits[k] for k in control), control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's TF32 is the card's")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gde_train.medium_19x9", "gde_serve.medium_19x9"])
def test_control_fails_on_the_card(tmp_path, card, workload):
    program, control, limits = _control(helpers.tiny_root(tmp_path), workload, card)
    assert all(program[k] <= limits[k] for k in program), program
    assert any(control[k] > limits[k] for k in control), control
