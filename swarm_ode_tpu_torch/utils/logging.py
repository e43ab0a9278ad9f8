"""Structured experiment logging with an optional wandb adapter (a copy of
`swarm_ode_tpu/utils/logging.py`, which imports no JAX, kept by the port).

The reference logs through prints plus wandb projects
`graph-ode-warehouse` and `swarm_ode` (train_gde.py:463-467,
run_gnode.py:1329-1333). Here metrics go through one structured logger;
wandb attaches when the package is importable, else logs go to an
in-memory history (also written as JSONL, and echoed to stdout on request).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(
        self,
        project: str,
        name: Optional[str] = None,
        config: Optional[Dict] = None,
        out_dir: Optional[str] = None,
        use_wandb: bool = True,
    ):
        self.project = project
        self.name = name or f"run_{int(time.time())}"
        self.config = config or {}
        self.history = []
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:  # pragma: no cover
                self._wandb = wandb
                wandb.init(project=project, name=self.name, config=config)
        self._file = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(
                os.path.join(out_dir, f"{self.name}.jsonl"), "a"
            )

    def log(self, metrics: Dict, step: Optional[int] = None, echo: bool = False):
        rec = {k: _to_py(v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        self.history.append(rec)
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        if echo:
            print(" | ".join(f"{k}={v}" for k, v in rec.items()), flush=True)

    def finish(self):
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
        if self._file is not None:
            self._file.close()


def _to_py(v):
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()
