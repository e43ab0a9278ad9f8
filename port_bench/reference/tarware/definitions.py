"""Core enums and constants for the TA-RWARE-compatible warehouse simulation.

Frozen copy, for the benchmark's reference, of the program's `definitions.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

Behavioral parity target: reference tarware/definitions.py:1-31. A copy of
`swarm_ode_tpu/definitions.py`.
Values are IntEnums, so they drop into int32 tensors without conversion.
"""
from __future__ import annotations

import enum


class AgentType(enum.IntEnum):
    """Reference: tarware/definitions.py:4-7."""

    AGV = 0
    PICKER = 1
    AGENT = 2  # used when num_pickers == 0: AGVs that can self-load


class Action(enum.IntEnum):
    """Micro actions. Reference: tarware/definitions.py:9-14."""

    NOOP = 0
    LEFT = 1
    RIGHT = 2
    FORWARD = 3
    TOGGLE_LOAD = 4


class Direction(enum.IntEnum):
    """Reference: tarware/definitions.py:16-20."""

    UP = 0
    DOWN = 1
    LEFT = 2
    RIGHT = 3


class RewardType(enum.IntEnum):
    """Reference: tarware/definitions.py:22-25."""

    GLOBAL = 0
    INDIVIDUAL = 1
    TWO_STAGE = 2


class CollisionLayers(enum.IntEnum):
    """Grid occupancy layers. Reference: tarware/definitions.py:27-31."""

    AGVS = 0
    PICKERS = 1
    SHELVES = 2
    CARRIED_SHELVES = 3


# (dx, dy) displacement for a FORWARD move in each direction, indexed by
# Direction value. Matches Agent.req_location (reference warehouse.py:42-56).
DIRECTION_DXDY = (
    (0, -1),  # UP
    (0, 1),  # DOWN
    (-1, 0),  # LEFT
    (1, 0),  # RIGHT
)

# Clockwise turn order used by req_direction / get_next_micro_action
# (reference warehouse.py:59, utils/utils.py:48). Maps Direction value ->
# index in the clockwise wheel [UP, RIGHT, DOWN, LEFT].
DIR_TO_WHEEL = (0, 2, 3, 1)  # UP->0, DOWN->2, LEFT->3, RIGHT->1
WHEEL_TO_DIR = (0, 3, 1, 2)  # wheel idx -> Direction value

# Steps an agent spends in "fixing clash" mode after a collision
# (reference warehouse.py:14).
FIXING_CLASH_TIME = 4
# Consecutive same-position steps before a stuck agent replans
# (reference warehouse.py:15).
STUCK_THRESHOLD = 5

# Per-step time penalty applied to every agent (reference warehouse.py:679).
STEP_PENALTY = 0.001
# Reward for a successful load/unload handoff (reference warehouse.py:547-549).
HANDOFF_REWARD_INDIVIDUAL = 0.1
HANDOFF_REWARD_GLOBAL = 0.5
# Reward for delivering a requested shelf (reference warehouse.py:609-611).
DELIVERY_REWARD = 1.0

# Seconds of simulated wall-clock per env step, used by the pick-rate metric
# (reference scripts/run_heuristic.py:56).
SECONDS_PER_STEP = 5.0
