"""Entry points of the flagship model: the port's counterparts of
`__graft_entry__.entry` and `__graft_entry__.dryrun_multichip`.

    fn, args = entry()        # on the card; entry("cpu") on the CPU
    positions = fn(*args)     # (8, 5, 5, 2): each node's position at t = 1

    dryrun_multichip(8)       # one train step on 8 gloo ranks (CPU), dp 4 x mp 2
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.parallel import mesh as meshlib
from swarm_ode_tpu_torch.utils.optim import adamw_init, adamw_update, clip_by_global_norm

NUM_AGVS, OBS_DIM, BATCH, WINDOW, NUM_AGENTS = 3, 119, 8, 5, 5
# The flagship GraphODE of entry() and dryrun_multichip.
FLAGSHIP = dict(node_dim=OBS_DIM, hidden_dim=64, ode_solver="euler")


def example_batch(device="cuda", batch: int = BATCH):
    """The JAX entry's example batch, drawn from RandomState(0) in its order:
    obs (batch, 5, 5, 119) in [0, 1), every window full, next positions
    (batch, 5, 2), weights 1."""
    rng = np.random.RandomState(0)
    obs = rng.rand(batch, WINDOW, NUM_AGENTS, OBS_DIM).astype(np.float32)
    next_pos = rng.rand(batch, NUM_AGENTS, 2).astype(np.float32)
    return {
        "obs": torch.from_numpy(obs).to(device),
        "count": torch.full((batch,), WINDOW, dtype=torch.int32, device=device),
        "next_pos": torch.from_numpy(next_pos).to(device),
        "weight": torch.ones(batch, dtype=torch.float32, device=device),
    }


def entry(device="cuda"):
    """(fn, args): the GraphODE trajectory model's whole-batch forward
    (structured aggregation, the path train_gde takes; euler over t = [0,
    1], hidden 64) on a batch of temporal warehouse graphs. fn(params, obs,
    count) -> (B, W, N, 2) positions at t = 1; args = (a state dict drawn
    by `GraphODE.init_` from seed 0, obs, count)."""
    model = GraphODE(**FLAGSHIP).to(device)
    model.init_(torch.Generator(device).manual_seed(0))
    batch = example_batch(device)
    t_span = torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)

    def fn(params, obs, count):
        g = build_temporal_batch(obs, count, NUM_AGVS)
        return functional_call(model, params, (g, t_span), strict=True)["trajectories"][1]

    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return fn, (params, batch["obs"], batch["count"])


class _Loss(nn.Module):
    """The training loss as a module's call, so that functional_call runs it
    with other parameters (the gathered ones)."""

    def __init__(self, model: GraphODE, loss_fn):
        super().__init__()
        self.model, self.loss_fn = model, loss_fn

    def forward(self, batch):
        return self.loss_fn(batch)


# The leaves stored as shards on `mp` (JAX's P(None, "mp") on a flax kernel
# (in, out) and P("mp") on a bias: the output rows of a torch weight).
MP_SHARDED = ("func.conv1.", "func.conv2.")


def mesh_train_step(model_kw: Dict, params: Optional[Dict[str, torch.Tensor]],
                    batch: Dict[str, torch.Tensor], mp: int = 1) -> Dict:
    """One GDE train step (train_gde._batch_loss, clip_by_global_norm(1.0),
    AdamW(1e-3, weight decay 1e-4): JAX's dry-run optimizer) over a dp x mp
    mesh of the process group's ranks on the CPU (a mesh of one rank
    without a group): the batch split on dp; the conv1 and conv2 leaves
    stored and updated as shards of their output rows on mp and gathered
    for the forward by a differentiable all-gather
    (parallel/mesh.gather_shards); every other leaf replicated. params: a
    state dict of GraphODE(**model_kw) (None: drawn by `init_` from seed
    0). Returns {'loss', 'params' (the whole updated state dict)} on every
    rank."""
    from swarm_ode_tpu_torch.train.train_gde import _batch_loss

    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    mesh = meshlib.make_mesh(("dp", "mp"), shape=(world // mp, mp), device="cpu")
    model = GraphODE(**model_kw)
    if params is None:
        model.init_(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(params)
    full = {k: v.detach().clone() for k, v in model.state_dict().items()}
    r = mesh.coords["mp"]
    sharded = {k for k in full if k.startswith(MP_SHARDED)}
    leaves = {k: (v.chunk(mp)[r].clone() if k in sharded else v).requires_grad_()
              for k, v in full.items()}
    mp_group = mesh.groups["mp"]

    def gathered():
        return {k: meshlib.gather_shards(mesh, v, "mp") if k in sharded else v
                for k, v in leaves.items()}

    share = meshlib.shard_batch(mesh, batch, "dp")
    if mesh.shape["dp"] > 1:
        share = {**share, "weight_total": float(batch["weight"].sum())}
    loss_mod = _Loss(model, _batch_loss(model, NUM_AGVS, 5.0))
    loss = functional_call(loss_mod, {f"model.{k}": v for k, v in gathered().items()}, (share,))
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    with torch.no_grad():
        *grads, loss = meshlib.all_reduce_sum(mesh, [*grads, loss.detach()], "dp")
        sq = [g.square().sum() for g in grads]
        norm = torch.sqrt(sum(q for k, q in zip(names, sq) if k not in sharded)
                          + meshlib.all_reduce_sum(
                              mesh, [sum(q for k, q in zip(names, sq) if k in sharded)],
                              "mp")[0])
        grads = clip_by_global_norm(grads, 1.0, norm=norm)
        new = [leaves[k].detach().clone() for k in names]
        adamw_update(new, grads, adamw_init(new), 1e-3, 1e-4)
    out = dict(zip(names, new))
    if mp_group is not None:
        out = {k: meshlib.all_gather(mesh, v, "mp") if k in sharded else v
               for k, v in out.items()}
    return {"loss": float(loss), "params": out}


def dryrun_multichip(n_devices: int, params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """One real train step of the flagship GDE over n gloo ranks on the CPU
    (it never touches the card, as JAX's dry run never touches the chip):
    a dp x mp mesh with mp = 2 when n is even, the batch of 2 dp example
    windows split on dp, the conv1 / conv2 weights tensor-parallel on mp
    (`mesh_train_step`). params: the initial state dict (convert's loader
    of JAX's init, say); None draws it from seed 0. Prints JAX's line and
    returns rank 0's {'loss', 'params'}."""
    mp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // mp
    batch = example_batch("cpu", batch=dp * 2)
    if params is not None:
        params = {k: v.detach().cpu() for k, v in params.items()}
    out = meshlib.launch(functools.partial(mesh_train_step, FLAGSHIP, params, batch, mp),
                         n_devices)[0]
    print(f"dryrun_multichip OK: mesh dp={dp} mp={mp}, loss={out['loss']:.4f}")
    return out
