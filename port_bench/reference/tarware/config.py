"""Environment configuration and the `tarware-...` naming-scheme registry.

Frozen copy, for the benchmark's reference, of the program's `config.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

The reference encodes env variants in gym id strings
(`tarware-{size}-{n}agvs-{m}pickers-{obs}obs-v1`, reference
tarware/__init__.py:26-45). Here the same scheme parses into an explicit
dataclass. A copy of `swarm_ode_tpu/config.py`: the same fields and the same
defaults, so that one `from_env_id(...)` call configures both packages.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from .definitions import RewardType

# (shelf_rows, shelf_columns) per size name (reference tarware/__init__.py:10-16)
SIZES = {
    "tiny": (1, 3),
    "small": (2, 3),
    "medium": (2, 5),
    "large": (3, 5),
    "extralarge": (4, 7),
}

# Request-queue size per size name (reference tarware/__init__.py:18-24)
REQUEST_QUEUES = {
    "tiny": 20,
    "small": 20,
    "medium": 20,
    "large": 40,
    "extralarge": 60,
}

OBS_TYPES = ("partial", "global")

_ENV_ID_RE = re.compile(
    r"^tarware-(?P<size>tiny|small|medium|large|extralarge)"
    r"-(?P<agvs>\d+)agvs-(?P<pickers>\d+)pickers-(?P<obs>partial|global)obs-v1$"
)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (hashable; jit-specialization key).

    Mirrors `Warehouse.__init__` kwargs (reference warehouse.py:95-108 and
    the registry defaults at tarware/__init__.py:33-44).
    """

    shelf_rows: int
    shelf_columns: int
    column_height: int = 8
    num_agvs: int = 1
    num_pickers: int = 0
    request_queue_size: int = 20
    max_inactivity_steps: Optional[int] = None
    max_steps: Optional[int] = 500
    reward_type: int = int(RewardType.INDIVIDUAL)
    normalised_coordinates: bool = False
    observation_type: str = "global"
    # --- rebuild extensions (no reference counterpart) ---
    # How agents flagged for replanning route around other agents:
    #   "bfs"    - BFS on the device with agents as obstacles (closest to the
    #              reference's find_path(care_for_agents=True)).
    #   "greedy" - one-step lookahead penalizing occupied cells (cheap).
    #   "off"    - keep following the static shortest-path field.
    replan_mode: str = "bfs"
    # Replan branch ('auto' | 'pallas' | 'xla'). 'xla' computes every agent's
    # full distance field (env/pathfinding.dynamic_fields, K3 on the card);
    # 'auto' and 'pallas' run the compacted own-cell query (K1 or K2 on the
    # card). Unlike the JAX package, which resolves 'auto' to 'xla' on a CPU
    # backend, this package does not resolve by platform: the tensors'
    # device decides only between the CUDA kernels and their plain versions.
    bfs_backend: str = "auto"
    # Replan-BFS relaxation sweeps; 0 = auto (max(32, 2*(H+W)//3)).
    dynamic_bfs_iters: int = 0
    # Replan kernel: 'int32' (min-plus distance row) or 'bitpack32' (1-bit
    # wavefront). 'auto' picks bitpack32 when the walled width fits one
    # 32-bit word (W+1 < 32, true for every predefined size) and int32
    # otherwise. Both give identical (distance, next hop) results.
    bfs_kernel: str = "auto"
    # Batched-replan compaction budget: the BFS runs only the rows the step
    # consumes (replanning agents, potential clash triggers, stuck
    # candidates), compacted across envs into a dense block of
    # row_frac * batch * agents rows. Exact for every consumed row; rows
    # beyond the budget are counted in info['replan_overflow'].
    # 1.0 disables compaction. 0.22 fits the rows needed with rejoin on;
    # with replan_rejoin=False raise it to 0.43.
    replan_row_frac: float = 0.22
    # Rejoin: drop an agent out of replan mode once its dynamic field
    # agrees with the static field at its own cell (same next hop, same
    # distance); a later blockage re-arms replanning through the normal
    # Phase-2 trigger.
    replan_rejoin: bool = True
    # Deadlock-break (no reference counterpart). 0 = reference semantics.
    # N > 0: after a hard stuck abandon the agent spends N steps taking
    # random highway-legal micro moves through the normal conflict rules.
    deadlock_break: int = 0

    @property
    def num_agents(self) -> int:
        return self.num_agvs + self.num_pickers

    @staticmethod
    def from_env_id(env_id: str, **overrides) -> "EnvConfig":
        """Parse a reference-style env id into a config.

        Reference naming: tarware/__init__.py:31.
        """
        m = _ENV_ID_RE.match(env_id)
        if m is None:
            raise ValueError(f"Unrecognized env id: {env_id!r}")
        size = m.group("size")
        rows, cols = SIZES[size]
        kwargs = dict(
            shelf_rows=rows,
            shelf_columns=cols,
            column_height=8,
            num_agvs=int(m.group("agvs")),
            num_pickers=int(m.group("pickers")),
            request_queue_size=REQUEST_QUEUES[size],
            max_inactivity_steps=None,
            max_steps=500,
            reward_type=int(RewardType.INDIVIDUAL),
            observation_type=m.group("obs"),
        )
        kwargs.update(overrides)
        return EnvConfig(**kwargs)


def env_id(size: str, num_agvs: int, num_pickers: int, obs_type: str) -> str:
    return f"tarware-{size}-{num_agvs}agvs-{num_pickers}pickers-{obs_type}obs-v1"
