"""GRU / LSTM trajectory-prediction baselines (reference
train_baselines.py:338-531).

Counterpart of `swarm_ode_tpu/train/train_baselines.py` (MODEL_FACTORIES
:28, BaselineTrainConfig :45, train_baseline :64): the reference's recipe
(AdamW, grad clip 1.0, batch 32, 80/20 split) and its loss, the MSE between
the predicted and the next positions per window, averaged with the windows'
weights, for four models of models/gru.py (GRU and LSTM on observations,
GRU and LSTM on positions alone).

As in train/train_gde.py: with equal-length episodes and `device_data`,
the episodes and positions stay on the device, each epoch's (n_batches, B,
2) window index pairs go up in one upload, every step cuts its windows on
the device (train_gde.window_batch with the windows' positions), and the
losses are read back once an epoch; otherwise the host gathers each batch.
The split and the shuffles are JAX's (`train_val_split`,
`RandomState(seed).permutation`), and the optimizer optax's
chain(clip_by_global_norm, adamw) over lists (utils/optim). Data parallel
over the ranks of a process group as train_gde is (its module docstring):
resident batches that divide over the ranks are split and their losses and
gradients summed, others computed whole on every rank, host batches padded
with weight-0 windows and split.

    python -m swarm_ode_tpu_torch.train.train_baselines --files data/*.h5
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset, train_val_split
from swarm_ode_tpu_torch.models.gru import (
    GRUTrajectoryPredictor,
    LSTMTrajectoryPredictor,
    PositionOnlyGRU,
    PositionOnlyLSTM,
)
from swarm_ode_tpu_torch.parallel import mesh as meshlib
from swarm_ode_tpu_torch.train.train_gde import (
    _total,
    eval_loss,
    host_share,
    pair_share,
    stack_episodes_streamed,
    train_step,
    weighted_mean,
)
from swarm_ode_tpu_torch.utils.optim import adamw_init

MODEL_FACTORIES = {
    "gru": lambda ds, hid: GRUTrajectoryPredictor(ds.obs_dim, ds.num_agents, hid),
    "lstm": lambda ds, hid: LSTMTrajectoryPredictor(ds.obs_dim, ds.num_agents, hid),
    "pos_gru": lambda ds, hid: PositionOnlyGRU(ds.num_agents, hid),
    "pos_lstm": lambda ds, hid: PositionOnlyLSTM(ds.num_agents, hid),
}


@dataclasses.dataclass
class BaselineTrainConfig:
    model: str = "gru"  # gru | lstm | pos_gru | pos_lstm
    num_epochs: int = 200
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    hidden_dim: int = 128
    seed: int = 0
    val_frac: float = 0.2
    # Keep the episodes in device memory and cut windows inside the step
    # (requires equal-length episodes); otherwise the host gathers windows.
    device_data: bool = True
    # Device storage of the episodes: 'float32', 'bfloat16' or 'uint8'
    # (train_gde.stack_episodes_streamed; both compact forms are exact for
    # the observations' small integers and flags).
    device_dtype: str = "float32"
    device: str = "cuda"


def baseline_loss(model: torch.nn.Module, position_only: bool):
    """loss_fn(batch): the MSE of model(batch['pos'] or batch['obs']) against
    batch['next_pos'] (B, N, 2) per window, averaged with batch['weight']
    (B,) and normalised by its sum (at least 1; train_gde.weighted_mean)."""

    def loss_fn(batch):
        pred = model(batch["pos"] if position_only else batch["obs"])
        return weighted_mean(((pred - batch["next_pos"]) ** 2).mean(dim=(1, 2)), batch)

    return loss_fn


def train_baseline(dataset: TrajectoryDataset,
                   config: BaselineTrainConfig = BaselineTrainConfig(), verbose: bool = True,
                   *, init_params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Train `config.model` on `dataset` on `config.device` (the card unless
    the config asks for the CPU; raises without one). `init_params`: a state
    dict to start from (convert.flax_params_to_state_dict of a JAX init,
    say); otherwise the parameters are drawn as flax draws them (`init_`)
    from torch.Generator(device).manual_seed(seed). Data parallel over the
    ranks of the default process group when one is up
    (parallel/mesh.make_mesh; "cuda" is then each rank's own card).

    Returns {'model', 'params' (a copy of the best epoch's state dict),
    'final_params', 'opt_state' (the final AdamWState), 'history',
    'best_val_loss'}."""
    mesh = meshlib.make_mesh(("dp",), device=config.device)
    device = mesh.device
    position_only = config.model.startswith("pos_")
    model = MODEL_FACTORIES[config.model](dataset, config.hidden_dim).to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.init_(torch.Generator(device).manual_seed(config.seed))
    params = list(model.parameters())
    opt_state = adamw_init(params)
    with torch.no_grad():
        meshlib.replicate(mesh, (params, opt_state))
    loss_fn = baseline_loss(model, position_only)

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    seq_len, B = dataset.seq_len, config.batch_size
    use_dev = config.device_data and len({ep.shape[0] for ep in dataset.episodes}) == 1
    data = {}
    if use_dev:
        index_np = np.asarray(dataset._index, np.int32)  # (M, 2)
        episodes_np, dev_dtype = stack_episodes_streamed(dataset.episodes, config.device_dtype)
        data = {"episodes": torch.from_numpy(episodes_np).to(dev_dtype).to(device),
                "positions": torch.from_numpy(np.stack(dataset._positions)).to(device)}

    def epoch_pairs(perm):
        """Full batches only, as one upload of (n_batches, B, 2)."""
        n_full = len(perm) // B
        pairs = np.ascontiguousarray(index_np[perm[: n_full * B]])
        return torch.from_numpy(pairs).to(device).view(n_full, B, 2)

    def pair_batch(pairs):
        return pair_share(mesh, data, pairs, seq_len, with_pos=True)

    def batch_at(idx):
        """The loss's batch (this rank's share on several) for windows `idx`:
        a host batch of the dataset's windows, or resident windows cut on the
        device."""
        if use_dev:
            pairs = np.ascontiguousarray(index_np[np.asarray(idx, np.int64)])
            return pair_batch(torch.from_numpy(pairs).to(device))
        raw = dataset.batch(idx)
        batch = {k: torch.from_numpy(raw[k]) for k in ("obs", "pos", "next_pos")}
        batch["weight"] = torch.ones(len(idx), dtype=torch.float32)
        return host_share(mesh, batch, device)

    def run(batches, train: bool):
        """Losses over an iterable of batches (train steps or evaluations),
        read back once at the end: (sum, count)."""
        nonlocal opt_state
        pending = []
        for batch in batches:
            if train:
                opt_state, loss = train_step(params, opt_state, loss_fn, batch, config, mesh)
            else:
                loss = eval_loss(loss_fn, batch, mesh)
            pending.append(loss)
        return _total(pending), len(pending)

    train_idx, val_idx = train_val_split(len(dataset), config.val_frac, config.seed)
    rng = np.random.RandomState(config.seed)
    history = {"train_loss": [], "val_loss": []}
    best_val, best_params = np.inf, snapshot()
    for epoch in range(config.num_epochs):
        t0 = time.time()
        perm = rng.permutation(train_idx)
        if use_dev:
            tot, nb = run((pair_batch(p) for p in epoch_pairs(perm)), True)
        else:
            tot, nb = run((batch_at(perm[i: i + B]) for i in range(0, len(perm) - B + 1, B)),
                          True)
        # A validation split shorter than a batch is one short batch.
        if use_dev and len(val_idx) >= B:
            vtot, vnb = run((pair_batch(p) for p in epoch_pairs(val_idx)), False)
        else:
            vtot, vnb = run((batch_at(val_idx[i: i + B])
                             for i in range(0, max(len(val_idx) - B + 1, 1), B)), False)
        train_loss, val_loss = tot / max(nb, 1), vtot / max(vnb, 1)
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        if val_loss < best_val:
            best_val, best_params = val_loss, snapshot()
        if verbose and mesh.rank == 0:
            print(f"[{config.model}] Epoch {epoch:3d} | Train: {train_loss:.6f}"
                  f" | Val: {val_loss:.6f} | {time.time() - t0:.1f}s", flush=True)
    return {"model": model, "params": best_params, "final_params": snapshot(),
            "opt_state": opt_state, "history": history, "best_val_loss": best_val}


def main(argv=None):
    """The CLI: scripts/train_baselines.py's flags and defaults, on the card
    unless --device says otherwise; data parallel under torchrun (rank 0
    prints)."""
    import argparse
    import os
    from pathlib import Path

    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--env_id", default="tarware-medium-19agvs-9pickers-partialobs-v1")
    p.add_argument("--seeds", nargs="*", type=int, default=[0, 1000, 2000, 3000, 4000])
    p.add_argument("--data_dir", default=".")
    p.add_argument("--files", nargs="*", default=None)
    p.add_argument("--models", nargs="*", default=list(MODEL_FACTORIES),
                   choices=list(MODEL_FACTORIES))
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--max_episodes", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    files = args.files or [
        str(Path(args.data_dir) / f"warehouse_data_{args.env_id}_seed{s}.h5") for s in args.seeds
    ]
    files = [f for f in files if Path(f).exists()]
    if not files:
        raise SystemExit("No dataset files found; run scripts/collect_data.py first.")
    ds = TrajectoryDataset.from_h5(files, seq_len=args.seq_len, max_episodes=args.max_episodes)
    for model in args.models:
        cfg = BaselineTrainConfig(model=model, num_epochs=args.num_epochs,
                                  batch_size=args.batch_size, hidden_dim=args.hidden_dim,
                                  device=args.device)
        out = train_baseline(ds, cfg)
        if int(os.environ.get("RANK", 0)) == 0:
            print(f"[{model}] best val loss: {out['best_val_loss']:.6f}")


if __name__ == "__main__":
    main()
