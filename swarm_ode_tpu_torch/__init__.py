"""PyTorch + CUDA port of swarm_ode_tpu.

Ported so far:
  * the batched heuristic warehouse rollout: config/layout (copies of the
    JAX package's numpy code), env state, reset and step, the FIFO
    dispatcher, and the replan BFS, compacted (K1 ops/bfs_bitpack.py, K2
    ops/bfs_pallas.query_call) or full-field (K3 ops/bfs_pallas.bfs_dist_call,
    `bfs_backend="xla"`);
  * GDE trajectory serving: observations, temporal graphs, SAGE layers
    (sparse aggregation through the segment sum K4, ops/segment_pallas.py),
    odeint, the GDE model and `serving.make_gde_fn`;
  * GDE training: odeint's gradients (autograd, checkpointing, the
    continuous adjoint), `data/dataset.py`, `train/train_gde.py` (optax's
    clip + AdamW written out), `utils/checkpoint.py`, `utils/logging.py`,
    and `entry.entry`, the flagship model's forward;
  * expert data generation: the stochastic and stateless heuristic experts,
    the env API (`env/env.py`, the action masks, `env/invariants.py`, the
    gym adapter `env/gym_adapter.py` with `make` and `register_gym_envs`
    below, `env/wrappers.py`, `env/rendering.py`) and offline datagen
    (`data/collect.py`, `data/hdf5_logger.py`, `utils/metrics.py`);
  * off-policy MARL: the hetero graph (`graphs/hetero.py`), the GNN and
    graph-ODE Q-networks and the QMIX mixers (`models/hetero_gnn.py`,
    `models/gnode.py`, `models/qmix.py`), n-step replay, the claim auction,
    IQL and QMIX (`rl/`), `train/run_rl.run_marl` with its CLI, and
    `serving.make_policy_fn`;
  * export: `serving.export_policy` / `export_gde` (torch.export, K4 as the
    custom op `swarm_ode_tpu_torch::segment_sum_planned`), `load_policy` /
    `load_gde`, episodes served from an artifact file (`python -m
    swarm_ode_tpu_torch.serving`), and the committed serving blobs'
    weights (`weights/*.npz`, `convert.committed_params`);
  * learning from the dispatcher and on-policy MARL (`train/train_bc.py`,
    COMA, MAPPO in `rl/ppo.py`) and the recurrent models (`models/gru.py`,
    `train/train_baselines.py`, graph-GRU IQL);
  * profiling (`utils/profiling.py`: `trace`, `StageTimer`,
    `device_throughput`), `full_registration` below, and data parallelism
    over torch.distributed (`parallel/mesh.py`): `train_gde`,
    `train_baseline` and MAPPO's `mesh_devices` over one rank per device,
    and `entry.dryrun_multichip`, a dp x mp train step on gloo ranks;
  * trajectory-model evaluation (`analysis.py`): the metric suite,
    `evaluate_gde` (K4 in every batch), `evaluate_baseline` and the
    evaluation CLI (`python -m swarm_ode_tpu_torch.analysis`);
  * the runner scripts' command lines: `python -m
    swarm_ode_tpu_torch.policies.heuristic run | parity | render` and
    `python -m swarm_ode_tpu_torch.data.dataset build-cache`.
The kernels' sources are under csrc/. What the JAX package has and the
port does not: the A* helper (`native/astar.cpp`, `utils/astar.py`),
which needs no port.

This package imports torch and numpy and never jax. Importing it builds
nothing; the CUDA kernels are compiled at first use on a GPU.

A function that takes a `device` (`env.state.make_params`, `make`,
`graphs.temporal.init_window`, the `convert.*_from_numpy` loaders,
`convert.committed_params`, `serving.load_policy` / `load_gde`,
`train.train_gde.train_gde`, `data.collect.collect_data`, `entry.entry`,
`analysis.evaluate_gde` / `evaluate_baseline`,
`parallel.mesh.make_mesh`; and `train.run_rl.run_marl` through
`RLRunConfig.device`) puts its tensors
on the card unless the caller passes `device="cpu"`; without a card such a
call raises. Everything else runs where its inputs
lie.
"""
from __future__ import annotations

import itertools

__version__ = "0.3.0"

_REGISTERED = False


def register_gym_envs():
    """Register every `tarware-{size}-{N}agvs-{M}pickers-{obs}obs-v1` id
    with gymnasium, made by the port's gym adapter (reference
    tarware/__init__.py:26-45).

    The ids are the JAX package's, so the two packages' registrations are
    mutually exclusive in one process. This call raises if an id is
    already registered to another entry point (the JAX package's
    `register_gym_envs` ran first). Call it before nothing else registers
    the ids; the JAX package's registration, once the port's has run,
    would silently take them back."""
    global _REGISTERED
    import gymnasium as gym

    from swarm_ode_tpu_torch.config import REQUEST_QUEUES, SIZES, env_id
    from swarm_ode_tpu_torch.definitions import RewardType

    entry = "swarm_ode_tpu_torch.env.gym_adapter:Warehouse"
    combos = list(itertools.product(SIZES, ("partial", "global"), range(1, 20), range(1, 10)))
    ids = [env_id(size, a, p, obs) for size, obs, a, p in combos]
    taken = sorted({gym.registry[i].entry_point for i in ids
                    if i in gym.registry and gym.registry[i].entry_point != entry})
    if taken:
        raise RuntimeError(
            f"the tarware ids are already registered to {taken}; the port's "
            "and the JAX package's registrations are mutually exclusive in one process")
    if _REGISTERED:
        return
    for i, (size, obs_type, num_agvs, num_pickers) in zip(ids, combos):
        gym.register(
            id=i,
            entry_point=entry,
            kwargs={
                "column_height": 8,
                "shelf_rows": SIZES[size][0],
                "shelf_columns": SIZES[size][1],
                "num_agvs": num_agvs,
                "num_pickers": num_pickers,
                "request_queue_size": REQUEST_QUEUES[size],
                "max_inactivity_steps": None,
                "max_steps": 500,
                "reward_type": RewardType.INDIVIDUAL,
                "observation_type": obs_type,
            },
        )
    _REGISTERED = True


def full_registration():
    """Alias of register_gym_envs (reference tarware/__init__.py:47-67: its
    version passes a `sensor_range` kwarg Warehouse never accepted, so the
    working equivalent is the standard registration)."""
    register_gym_envs()


def make(env_id_str: str, device="cuda", **overrides):
    """The port's gym-adapter Warehouse for a reference-style env id, on
    `device` (no gymnasium registry required)."""
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.gym_adapter import Warehouse

    cfg = EnvConfig.from_env_id(env_id_str, **overrides)
    return Warehouse(
        shelf_columns=cfg.shelf_columns,
        column_height=cfg.column_height,
        shelf_rows=cfg.shelf_rows,
        num_agvs=cfg.num_agvs,
        num_pickers=cfg.num_pickers,
        request_queue_size=cfg.request_queue_size,
        max_inactivity_steps=cfg.max_inactivity_steps,
        max_steps=cfg.max_steps,
        reward_type=cfg.reward_type,
        normalised_coordinates=cfg.normalised_coordinates,
        observation_type=cfg.observation_type,
        replan_mode=cfg.replan_mode,
        device=device,
    )
