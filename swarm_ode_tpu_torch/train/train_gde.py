"""Offline Graph-ODE trajectory training (reference train_gde.py:428-535).

Counterpart of `swarm_ode_tpu/train/train_gde.py`. Recipe parity: AdamW
(lr 1e-3, weight decay 1e-4), grad clip 1.0, batch 32, 200 epochs, 80/20
split, MSE between the ODE solution's t=1 decoded positions of the
current-frame nodes and the next-step positions (train_gde.py:469-535).

On the card the episodes live in device memory (all of them, or one shard
at a time), the host ships each epoch's (n_batches, B, 2) window index
pairs in one upload, and every step cuts its windows and builds its
temporal graphs on the device (`_extract_windows`,
graphs/temporal.build_temporal_batch). The loss is read back once every
`epoch_scan_chunk` batches (once an epoch by default), never after each
step, so no step waits on the host. Training aggregates on the structured
form (`GraphODE.apply_batched` without edges), as the JAX trainer does.

The optimizer is optax's chain(clip_by_global_norm, adamw) written out over
lists of tensors with explicit state (`utils/optim.py`), and the split,
shuffles and batches come from `np.random.RandomState(config.seed)` in the
JAX trainer's order, so both packages take the same steps on the same
batches.

Data parallel as the JAX trainer's `dp` mesh, over one rank per device
(parallel/mesh.py; `torchrun --nproc_per_node=N -m
swarm_ode_tpu_torch.train.train_gde ...` on N cards). Every rank draws the
same split and shuffles and holds the parameters, replicated from rank 0.
A batch of B resident windows that divides over the n ranks is split: each
rank computes its B/n windows' share of the loss (their weighted sum over
the whole batch's weight), and the shares and their gradients are summed
over the ranks before the clip and AdamW, so the parameters stay equal on
every rank. A batch that does not divide is computed whole by every rank,
as JAX replicates it, and nothing is summed. Host-gathered batches are
padded to a multiple of n with weight-0 windows and split. Rank 0 writes
the checkpoints and the logs; every rank restores. On one rank no batch is
split and nothing is communicated.

    python -m swarm_ode_tpu_torch.train.train_gde --files data/*.h5
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset, train_val_split
from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.parallel import mesh as meshlib
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager
from swarm_ode_tpu_torch.utils.optim import (AdamWState, adamw_init, adamw_update,
                                             clip_by_global_norm)
from swarm_ode_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class GDETrainConfig:
    num_epochs: int = 200
    batch_size: int = 32
    lr: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    hidden_dim: int = 64
    ode_solver: str = "euler"
    distance_threshold: float = 5.0
    seed: int = 0
    val_frac: float = 0.2
    # Keep the episodes in device memory and cut windows inside the step
    # (requires equal-length episodes); otherwise the host gathers windows.
    device_data: bool = True
    # Rotate at most this many episodes through device memory at a time
    # (0 = all resident). The split is then by episode, and shuffling is
    # shard-local (shard order and order within a shard, each epoch).
    device_shard_episodes: int = 0
    # Device storage of the episodes: 'float32', 'bfloat16' (exact for the
    # observations' small integers and flags) or 'uint8' (checked: integral
    # observations in [0, 255], true of the reference envs).
    device_dtype: str = "float32"
    # Supervise the ODE at t = 1..horizon (one solve, a loss at every
    # integer time); horizon=1 is the reference recipe. horizon>1 requires
    # the device-resident data path.
    horizon: int = 1
    # Batches between two readbacks of the training loss (0 = once an
    # epoch). Steps never wait on a readback in between.
    epoch_scan_chunk: int = 0
    # Per-horizon loss weights (length == horizon, horizon>1 only; None =
    # uniform), e.g. (3, 1, 1, 1) to favour t=+1.
    horizon_weights: Optional[tuple] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "uint8": torch.uint8}


def weighted_mean(losses: torch.Tensor, batch: Dict) -> torch.Tensor:
    """sum(losses * weight) / max(sum(weight), 1) over the batch's windows.
    Where a rank holds a share of a batch, the batch's `weight_total` (the
    whole batch's weight sum) is the denominator, so the ranks' results sum
    to the whole batch's."""
    weights, total = batch["weight"], batch.get("weight_total")
    den = weights.sum().clamp(min=1.0) if total is None else max(total, 1.0)
    return (losses * weights).sum() / den


def _batch_loss(model: GraphODE, num_agvs, distance_threshold, horizon: int = 1,
                horizon_weights=None):
    """loss_fn(batch) on the structured batched path, with the model's
    parameters. horizon=1: the reference's t=1-endpoint MSE of the newest
    frame's agents against `next_pos` (B, N, 2). horizon>1: MSE at t =
    1..horizon against `next_pos` (B, Hz, N, 2), each horizon weighted by
    the batch's `hweight` (B, Hz) times `horizon_weights` and normalised by
    their sum. Windows are weighted by `weight` (B,) and normalised by its
    sum (`weighted_mean`). Raises ValueError on horizon_weights of the wrong
    length or with horizon 1."""
    if horizon_weights is not None:
        if len(horizon_weights) != horizon:
            raise ValueError(f"horizon_weights needs length {horizon}, got "
                             f"{len(horizon_weights)}")
        if horizon == 1:
            raise ValueError("horizon_weights requires horizon > 1")
    hw_on = {}  # horizon_weights as a tensor, made once per device

    def loss_fn(batch):
        obs, count = batch["obs"], batch["count"]
        B, W, N, _ = obs.shape
        g = build_temporal_batch(obs, count, num_agvs, distance_threshold)
        t_span = torch.arange(horizon + 1, dtype=torch.float32, device=obs.device)
        traj = model.apply_batched(g, t_span)["trajectories"]  # (T, B, W, N, 2)
        cur_slot = (count.long() - 1).clamp(min=0)
        if horizon == 1:
            cur = traj[1].gather(1, cur_slot[:, None, None, None].expand(B, 1, N, 2))[:, 0]
            losses = ((cur - batch["next_pos"]) ** 2).mean(dim=(1, 2))
        else:
            idx = cur_slot[None, :, None, None, None].expand(horizon, B, 1, N, 2)
            cur = traj[1:].gather(2, idx)[:, :, 0]  # (Hz, B, N, 2)
            tgt = batch["next_pos"].movedim(1, 0)
            per = ((cur - tgt) ** 2).mean(dim=(2, 3))  # (Hz, B)
            hw = batch["hweight"].movedim(1, 0)
            if horizon_weights is not None:
                if obs.device not in hw_on:
                    hw_on[obs.device] = torch.tensor(horizon_weights, dtype=torch.float32,
                                                     device=obs.device)
                hw = hw * hw_on[obs.device][:, None]
            losses = (per * hw).sum(dim=0) / hw.sum(dim=0).clamp(min=1.0)
        return weighted_mean(losses, batch)

    return loss_fn


def _integral_u8(x: np.ndarray, where: str) -> None:
    lo, hi = float(x.min()), float(x.max())
    if not (0.0 <= lo and hi <= 255.0 and np.array_equal(x, np.floor(x))):
        raise ValueError(f"device_dtype='uint8' needs integral obs in [0, 255]; {where} "
                         f"[{lo}, {hi}]")


def compact_episodes(episodes_np: np.ndarray, device_dtype: str):
    """The host array to upload and the torch storage dtype for
    `device_dtype` in {'float32', 'bfloat16', 'uint8'}; uint8 is checked:
    the observations must be integral in [0, 255]."""
    dev_dtype = _DTYPES[device_dtype]
    if device_dtype == "uint8":
        _integral_u8(episodes_np, "got range")
        episodes_np = episodes_np.astype(np.uint8)
    return episodes_np, dev_dtype


def stack_episodes_streamed(episodes, device_dtype: str):
    """compact_episodes(np.stack(episodes), ...) filled episode by episode
    into one preallocated output in the final host dtype, without the
    whole-dataset temporaries (the uint8 check included)."""
    dev_dtype = _DTYPES[device_dtype]
    shape = (len(episodes),) + tuple(episodes[0].shape)
    if device_dtype == "uint8":
        out = np.empty(shape, np.uint8)
        for e, ep in enumerate(episodes):
            x = np.asarray(ep)
            _integral_u8(x, f"episode {e} has range")
            out[e] = x
        return out, dev_dtype
    out = np.empty(shape, np.asarray(episodes[0]).dtype)
    for e, ep in enumerate(episodes):
        out[e] = ep
    return out, dev_dtype


def _extract_windows(episodes_dev, positions_dev, seq_len, e_idx, t_idx, with_pos=False,
                     horizon: int = 1, true_len: Optional[int] = None):
    """(ep, t) index pairs -> TrajectoryDataset.window's semantics as one
    batched gather on the device: the W frames from start = clip(t-W+1, 0,
    T-W), those after t zeroed (the warm-up), count = min(t+1, W) and the
    next positions. With horizon > 1 the targets are t+1 .. t+horizon of the
    positions (edge-padded by `horizon` frames at upload, so they never run
    past the end) and hweight marks those within the episode's `true_len`.
    With `with_pos` the window's positions (W, N, 2), zeroed alike, come
    last in place of hweight, as in the JAX function. Nothing here
    synchronises with the host."""
    W = seq_len
    e, t = e_idx.long(), t_idx.long()
    start = (t - W + 1).clamp(min=0, max=episodes_dev.shape[1] - W)
    slot_t = start[:, None] + torch.arange(W, device=t.device)  # (B, W)
    valid = (slot_t <= t[:, None])[..., None, None]
    obs_w = torch.where(valid, episodes_dev[e[:, None], slot_t].to(torch.float32), 0.0)
    count = (t + 1).clamp(max=W).to(torch.int32)
    if horizon > 1:
        steps = t[:, None] + 1 + torch.arange(horizon, device=t.device)  # (B, Hz)
        next_pos = positions_dev[e[:, None], steps]
        hweight = (steps <= true_len - 1).to(torch.float32)
    else:
        next_pos = positions_dev[e, t + 1]
    if with_pos:
        return obs_w, count, next_pos, torch.where(valid, positions_dev[e[:, None], slot_t], 0.0)
    if horizon > 1:
        return obs_w, count, next_pos, hweight
    return obs_w, count, next_pos


def window_batch(data, pairs, seq_len: int, horizon: int = 1, true_len=None,
                 with_pos: bool = False) -> Dict:
    """The loss's batch for (B, 2) (episode, step) pairs on the device,
    cut from `data` ({'episodes', 'positions'} on the device), every window
    weighted 1; with `with_pos` the windows' positions as 'pos'."""
    cut = _extract_windows(data["episodes"], data["positions"], seq_len, pairs[:, 0],
                           pairs[:, 1], with_pos=with_pos, horizon=horizon, true_len=true_len)
    batch = dict(zip(("obs", "count", "next_pos", "pos" if with_pos else "hweight"), cut))
    batch["weight"] = torch.ones(pairs.shape[0], dtype=torch.float32, device=pairs.device)
    return batch


def pair_share(mesh: meshlib.Mesh, data, pairs: torch.Tensor, seq_len: int, **window) -> Dict:
    """window_batch of (rows, 2) pairs on the device. On several ranks and
    rows that divide over them, this rank's share of the batch, with the
    whole batch's `weight_total`; otherwise the whole batch, which every
    rank computes (JAX replicates a batch that does not divide)."""
    if mesh.size == 1 or pairs.shape[0] % mesh.size:
        return window_batch(data, pairs, seq_len, **window)
    batch = window_batch(data, meshlib.shard_batch(mesh, pairs), seq_len, **window)
    batch["weight_total"] = float(pairs.shape[0])
    return batch


def host_share(mesh: meshlib.Mesh, batch: Dict[str, torch.Tensor], device) -> Dict:
    """A host batch (CPU tensors, its 'weight' included) on the device. On
    several ranks it is first padded to a multiple of them with weight-0
    windows, and only this rank's share goes up, with the whole batch's
    `weight_total`."""
    if mesh.size == 1:
        return {k: v.to(device) for k, v in batch.items()}
    total = float(batch["weight"].sum())
    batch, valid = meshlib.pad_to_multiple(batch, mesh.size)
    batch["weight"] = batch["weight"] * valid
    batch = {k: v.to(device) for k, v in meshlib.shard_batch(mesh, batch).items()}
    batch["weight_total"] = total
    return batch


def _shared(mesh, batch) -> bool:
    return mesh is not None and "weight_total" in batch


def train_step(params: Sequence[torch.Tensor], opt_state: AdamWState, loss_fn, batch: Dict,
               config: GDETrainConfig, mesh: Optional[meshlib.Mesh] = None):
    """One step: the loss and its gradients, the clip, AdamW on `params` in
    place. Returns (new optimizer state, the loss, detached, on the
    device); nothing waits on the host. Where the batch is this rank's
    share (it carries `weight_total`), the loss and the gradients are
    first summed over the mesh's dp axis, in one collective."""
    loss = loss_fn(batch)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        if _shared(mesh, batch):
            *grads, loss = meshlib.all_reduce_sum(mesh, [*grads, loss])
        grads = clip_by_global_norm(grads, config.grad_clip)
        opt_state = adamw_update(params, grads, opt_state, config.lr, config.weight_decay)
    return opt_state, loss.detach()


@torch.no_grad()
def eval_loss(loss_fn, batch: Dict, mesh: Optional[meshlib.Mesh] = None) -> torch.Tensor:
    """The batch's loss, without gradients; a rank's share of a batch
    summed over the mesh's dp axis."""
    loss = loss_fn(batch)
    return meshlib.all_reduce_sum(mesh, [loss])[0] if _shared(mesh, batch) else loss


def _total(losses: List[torch.Tensor]) -> float:
    """One readback of a run of per-batch losses, summed in float32 as a
    scan's losses are."""
    return float(torch.stack(losses).sum()) if losses else 0.0


def train_gde(dataset: TrajectoryDataset, config: GDETrainConfig = GDETrainConfig(),
              logger: Optional[MetricsLogger] = None, verbose: bool = True, *,
              device="cuda", init_params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Train GraphODE on a trajectory dataset on `device` (the card unless
    the caller asks for the CPU; raises without one). `init_params`: a
    state dict to start from (convert.gde_params_from_numpy of a JAX init,
    say); otherwise the parameters are drawn as flax draws them
    (`GraphODE.init_`) from torch.Generator(device).manual_seed(seed).
    Data parallel over the ranks of the default process group when one is
    up (parallel/mesh.make_mesh; "cuda" is then each rank's own card).

    Returns {'model', 'params' (a copy of the best epoch's state dict),
    'final_params', 'opt_state' (the final AdamWState), 'history',
    'best_val_loss'}."""
    mesh = meshlib.make_mesh(("dp",), device=device)
    device = mesh.device
    model = GraphODE(node_dim=dataset.obs_dim, num_agvs=dataset.num_agvs,
                     num_pickers=dataset.num_pickers, hidden_dim=config.hidden_dim,
                     ode_solver=config.ode_solver).to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.init_(torch.Generator(device).manual_seed(config.seed))
    params = list(model.parameters())
    opt_state = adamw_init(params)
    with torch.no_grad():
        meshlib.replicate(mesh, (params, opt_state))

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    loss_fn = _batch_loss(model, dataset.num_agvs, config.distance_threshold,
                          horizon=config.horizon, horizon_weights=config.horizon_weights)

    ep_lens = {ep.shape[0] for ep in dataset.episodes}
    use_dev = config.device_data and len(ep_lens) == 1
    if config.horizon > 1 and not use_dev:
        raise ValueError("horizon>1 requires the device-resident data path "
                         "(device_data=True with equal-length episodes)")
    true_len = next(iter(ep_lens)) if use_dev else None
    E = len(dataset.episodes)
    shard_eps = min(config.device_shard_episodes or E, E) if use_dev else E
    sharded = use_dev and shard_eps < E
    seq_len, B = dataset.seq_len, config.batch_size
    data = {}
    if use_dev:
        episodes_np, dev_dtype = stack_episodes_streamed(dataset.episodes, config.device_dtype)
        positions_np = np.stack(dataset._positions)
        if config.horizon > 1:
            # Edge-padded so the (t+1, horizon) targets never run past the
            # end; hweight masks the padded frames.
            positions_np = np.pad(positions_np, ((0, 0), (0, config.horizon), (0, 0), (0, 0)),
                                  mode="edge")
        index_np = np.asarray(dataset._index, np.int32)  # (M, 2)

    def put(ep_ids=None):
        """The episodes (all, or one shard) on the device."""
        eps = episodes_np if ep_ids is None else episodes_np[ep_ids]
        pos = positions_np if ep_ids is None else positions_np[ep_ids]
        return {"episodes": torch.from_numpy(eps).to(dev_dtype).to(device),
                "positions": torch.from_numpy(pos).to(device)}

    if use_dev and not sharded:
        data = put()

    def put_shard(ep_ids):
        """One episode shard on the device, and the map from a global
        episode id to its slot in the shard."""
        remap = np.full(E, -1, np.int64)
        remap[ep_ids] = np.arange(len(ep_ids))
        return put(ep_ids), remap

    def device_pairs(idx, remap=None):
        """(len(idx), 2) index pairs on the device, episodes remapped into
        the shard."""
        pairs = index_np[np.asarray(idx, np.int64)]
        if remap is not None:
            pairs = np.stack([remap[pairs[:, 0]], pairs[:, 1]], axis=1)
        return torch.from_numpy(np.ascontiguousarray(pairs, np.int32)).to(device)

    def epoch_pairs(perm, remap=None):
        """Full batches only (the remainder is dropped), as one upload of
        (n_batches, B, 2)."""
        n_full = len(perm) // B
        return device_pairs(perm[: n_full * B], remap).view(n_full, B, 2)

    def pair_batch(pairs, sdata=None):
        return pair_share(mesh, sdata or data, pairs, seq_len, horizon=config.horizon,
                          true_len=true_len)

    def batch_at(idx, sdata=None, remap=None):
        """The loss's batch (this rank's share on several) for windows `idx`,
        on the device."""
        if use_dev:
            return pair_batch(device_pairs(idx, remap), sdata)
        raw = dataset.batch(idx)
        batch = {k: torch.from_numpy(raw[k]) for k in ("obs", "count", "next_pos")}
        batch["weight"] = torch.ones(len(idx), dtype=torch.float32)
        return host_share(mesh, batch, device)

    def run(batches, chunk, train: bool):
        """Losses over an iterable of batches: train steps or evaluations,
        read back every `chunk` batches (0: once, at the end). Returns
        (sum, count)."""
        nonlocal opt_state
        tot, n, pending = 0.0, 0, []
        for batch in batches:
            if train:
                opt_state, loss = train_step(params, opt_state, loss_fn, batch, config, mesh)
            else:
                loss = eval_loss(loss_fn, batch, mesh)
            pending.append(loss)
            if len(pending) == chunk:
                tot, n, pending = tot + _total(pending), n + len(pending), []
        return tot + _total(pending), n + len(pending)

    def scan(pairs, train: bool, sdata=None):
        """`run` over the batches of an uploaded (n_batches, B, 2) pair
        tensor, read back every `epoch_scan_chunk` batches."""
        return run((pair_batch(p, sdata) for p in pairs), config.epoch_scan_chunk, train)

    if sharded:
        # Episode-level split when rotating shards (no window leaks across
        # the split); the window-level split applies in the resident paths.
        ep_perm = np.random.RandomState(config.seed).permutation(E)
        n_val_ep = max(1, int(E * config.val_frac))
        val_eps, train_eps = np.sort(ep_perm[:n_val_ep]), np.sort(ep_perm[n_val_ep:])
        win_ep = index_np[:, 0]
        train_shards = [train_eps[i: i + shard_eps] for i in range(0, len(train_eps), shard_eps)]
        val_shards = [val_eps[i: i + shard_eps] for i in range(0, len(val_eps), shard_eps)]
        train_win = [np.nonzero(np.isin(win_ep, s))[0] for s in train_shards]
        val_win = [np.nonzero(np.isin(win_ep, s))[0] for s in val_shards]
    else:
        train_idx, val_idx = train_val_split(len(dataset), config.val_frac, config.seed)
    rng = np.random.RandomState(config.seed)
    history = {"train_loss": [], "val_loss": []}
    best_val = np.inf
    best_params = snapshot()
    ckpt = None
    start_epoch = 0

    def ckpt_state(epoch):
        return {"params": dict(model.state_dict()),
                "opt_state": {"count": opt_state.count, "mu": opt_state.mu, "nu": opt_state.nu},
                "epoch": int(epoch)}

    if config.checkpoint_dir:
        ckpt = CheckpointManager(config.checkpoint_dir)
        # Resume: parameters, optimizer state and epoch. The shuffles start
        # again from `seed`, as in the JAX trainer.
        latest = ckpt.latest_step()
        if latest is not None:
            restored = ckpt.restore(ckpt_state(0))
            model.load_state_dict(restored["params"])
            opt = restored["opt_state"]
            opt_state = AdamWState(opt["count"], list(opt["mu"]), list(opt["nu"]))
            start_epoch = restored["epoch"] + 1
            if verbose and mesh.rank == 0:
                print(f"Resumed from checkpoint at epoch {latest}")
        if mesh.size > 1:
            # No rank trains (and rank 0 writes) before every rank has read.
            torch.distributed.barrier()

    for epoch in range(start_epoch, config.num_epochs):
        t0 = time.time()
        if sharded:
            tot, nb = 0.0, 0
            for si in rng.permutation(len(train_shards)):
                sdata, remap = put_shard(train_shards[si])
                s, n = scan(epoch_pairs(rng.permutation(train_win[si]), remap), True, sdata)
                tot, nb = tot + s, nb + n
        elif use_dev:
            tot, nb = scan(epoch_pairs(rng.permutation(train_idx)), True)
        else:
            perm = rng.permutation(train_idx)
            tot, nb = run((batch_at(perm[i: i + B]) for i in range(0, len(perm) - B + 1, B)),
                          config.epoch_scan_chunk, True)
        train_loss = tot / max(nb, 1)

        # A split shorter than a batch is evaluated as one short batch.
        if sharded:
            vtot, vnb = 0.0, 0
            for si in range(len(val_shards)):
                sdata, remap = put_shard(val_shards[si])
                vw = val_win[si]
                s, n = run((batch_at(vw[i: i + B], sdata, remap)
                            for i in range(0, max(len(vw) - B + 1, 1), B)), 0, False)
                vtot, vnb = vtot + s, vnb + n
        elif use_dev and len(val_idx) >= B:
            vtot, vnb = scan(epoch_pairs(val_idx), False)
        else:
            vtot, vnb = run((batch_at(val_idx[i: i + B])
                             for i in range(0, max(len(val_idx) - B + 1, 1), B)), 0, False)
        val_loss = vtot / max(vnb, 1)
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        if val_loss < best_val:
            best_val = val_loss
            best_params = snapshot()
        if mesh.rank != 0:
            continue
        if ckpt and (val_loss == best_val or epoch % config.checkpoint_every == 0):
            ckpt.save(epoch, ckpt_state(epoch), force=True)
        if logger:
            logger.log({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss})
        if verbose:
            print(f"Epoch {epoch:3d} | Train Loss: {train_loss:.6f} "
                  f"| Val Loss: {val_loss:.6f} | {time.time() - t0:.1f}s", flush=True)

    return {
        "model": model,
        "params": best_params,
        "final_params": snapshot(),
        "opt_state": opt_state,
        "history": history,
        "best_val_loss": best_val,
    }


def main(argv=None):
    """The CLI: scripts/train_gde.py's flags and defaults, on the card
    unless --device says otherwise; data parallel under torchrun (rank 0
    prints and logs)."""
    import argparse
    import os
    from pathlib import Path

    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--env_id", default="tarware-medium-19agvs-9pickers-partialobs-v1")
    p.add_argument("--seeds", nargs="*", type=int, default=[0, 1000, 2000, 3000, 4000])
    p.add_argument("--data_dir", default=".")
    p.add_argument("--files", nargs="*", default=None,
                   help="explicit h5 paths (overrides env_id/seeds naming)")
    p.add_argument("--num_epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--ode_solver", default="euler", choices=["euler", "midpoint", "rk4", "dopri5"])
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--max_episodes", type=int, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    files = args.files or [
        str(Path(args.data_dir) / f"warehouse_data_{args.env_id}_seed{s}.h5") for s in args.seeds
    ]
    files = [f for f in files if Path(f).exists()]
    if not files:
        raise SystemExit("No dataset files found; run scripts/collect_data.py first.")
    ds = TrajectoryDataset.from_h5(files, seq_len=args.seq_len, max_episodes=args.max_episodes)
    lead = int(os.environ.get("RANK", 0)) == 0
    if lead:
        print(f"Loaded {len(ds)} step pairs from {len(files)} files "
              f"(node dim {ds.obs_dim}; {ds.num_agvs} AGVs, {ds.num_pickers} Pickers)")
    cfg = GDETrainConfig(num_epochs=args.num_epochs, batch_size=args.batch_size, lr=args.lr,
                         weight_decay=args.weight_decay, hidden_dim=args.hidden_dim,
                         ode_solver=args.ode_solver, checkpoint_dir=args.checkpoint_dir)
    logger = (MetricsLogger("graph-ode-warehouse", config=vars(args), out_dir="runs")
              if lead else None)
    out = train_gde(ds, cfg, logger=logger, device=args.device)
    if lead:
        logger.finish()
        print(f"Best val loss: {out['best_val_loss']:.6f}")


if __name__ == "__main__":
    main()
