"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program at a tiny size on the CPU
(the harness's look for a card skipped), and the rest of the run as the
card runs it."""
from __future__ import annotations

import pytest

from port_bench.faults import serve_fault, step_fault, train_fault
from port_bench.tests import helpers


FAULTS = [("rollout.medium_19x9", step_fault, k) for k in ("unchanged", "half", "altered")]
FAULTS += [("gde_train.medium_19x9", train_fault, k) for k in ("unchanged", "half", "altered")]
FAULTS += [("gde_serve.medium_19x9", serve_fault, k) for k in ("half", "altered")]


@pytest.mark.parametrize("workload,fault,kind", FAULTS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, workload, fault, kind):
    root = helpers.tiny_root(tmp_path, rollout={"sample_envs": 10})
    assert helpers.run(root, workload)["correct"] is True
    monkeypatch.setattr(*fault(kind))
    res = helpers.run(root, workload)
    assert res["correct"] is False, res["checks"]
