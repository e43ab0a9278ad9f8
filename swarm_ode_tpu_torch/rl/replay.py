"""Ring replay buffer of nested dicts of tensors, on the card.

Counterpart of `swarm_ode_tpu/rl/replay.py` (init, add, add_batch :53,
sample, sample_recent, sample_nstep :88, clear), replacing the reference's
Python deques of PyG graphs (run_gnode.py:1011-1039). An item is a nested
dict of fixed-shape tensors (a GRU network's hidden states are a tuple in
it); the storage holds each leaf as (capacity, ...) on the items' device,
and transitions keep the hetero graph's node features only (the adjacency
is rebuilt from them at sample time).

`ptr` and `size` are host integers: they depend only on how many items were
written, so a caller can test readiness without reading the device. The
samplers take their indices from `idx` when given (the tests pass JAX's
own draws) or draw them from `generator`; neither waits on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


def _map(fn, *trees):
    """fn over the leaves of nested dicts and tuples of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, (dict, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


@dataclasses.dataclass
class ReplayBuffer:
    storage: Dict[str, Any]  # nested dicts / tuples of (capacity, ...) tensors
    ptr: int  # next write slot
    size: int  # filled slots

    @property
    def capacity(self) -> int:
        return _first_leaf(self.storage).shape[0]

    def nbytes(self) -> int:
        """Device bytes of the storage."""
        total = []
        _map(lambda s: total.append(s.numel() * s.element_size()), self.storage)
        return sum(total)


def init(example_item, capacity: int) -> ReplayBuffer:
    """An empty buffer for items shaped like `example_item` (nested dict of
    tensors, on the device the storage should live on)."""
    storage = _map(lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                                         device=x.device), example_item)
    return ReplayBuffer(storage=storage, ptr=0, size=0)


def add(buf: ReplayBuffer, item) -> ReplayBuffer:
    """Write one item at `ptr`, in place."""
    _map(lambda s, x: s.__setitem__(buf.ptr, x), buf.storage, item)
    cap = buf.capacity
    return ReplayBuffer(buf.storage, (buf.ptr + 1) % cap, min(buf.size + 1, cap))


def add_batch(buf: ReplayBuffer, items) -> ReplayBuffer:
    """Write B items (leading axis) at ptr, ptr + 1, ... with ring
    wraparound, in place. The storage is updated in place: a buffer handed
    to `add_batch` is the returned one's storage."""
    cap = buf.capacity
    B = _first_leaf(items).shape[0]
    start = buf.ptr
    if start + B <= cap:
        _map(lambda s, x: s[start:start + B].copy_(x), buf.storage, items)
    else:
        dev = _first_leaf(buf.storage).device
        idx = (start + torch.arange(B, device=dev)) % cap
        _map(lambda s, x: s.index_copy_(0, idx, x), buf.storage, items)
    return ReplayBuffer(buf.storage, (start + B) % cap, min(buf.size + B, cap))


def _indices(buf: ReplayBuffer, batch_size: int, generator, idx):
    if idx is not None:
        return idx.long()
    dev = _first_leaf(buf.storage).device
    return torch.randint(0, max(buf.size, 1), (batch_size,), generator=generator, device=dev)


def sample(buf: ReplayBuffer, batch_size: int, generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None):
    """Uniform sample with replacement over the filled slots (reference
    random.sample, run_gnode.py:619)."""
    idx = _indices(buf, batch_size, generator, idx)
    return _map(lambda s: s[idx], buf.storage)


def sample_recent(buf: ReplayBuffer, batch_size: int, window: int,
                  generator: Optional[torch.Generator] = None,
                  off: Optional[torch.Tensor] = None):
    """Uniform sample over the newest `window` written slots (ptr-1, ptr-2,
    ... mod capacity); `off` (batch,) in [1, min(window, size)] when given."""
    cap = buf.capacity
    if off is None:
        w = max(min(window, buf.size), 1)
        dev = _first_leaf(buf.storage).device
        off = torch.randint(1, w + 1, (batch_size,), generator=generator, device=dev)
    idx = (buf.ptr - off.long()) % cap
    return _map(lambda s: s[idx], buf.storage)


def sample_nstep(buf: ReplayBuffer, batch_size: int, n: int, stride: int,
                 generator: Optional[torch.Generator] = None,
                 idx: Optional[torch.Tensor] = None):
    """Uniform sample with n-step chains, as the JAX function: items carry
    scalar `_t` (global env step), `_ep` (episode) and `done`; with
    `add_batch` writing `stride` lockstep envs a step, the same env's item k
    steps later sits k*stride slots ahead. A link is valid while `_t`
    advances by exactly 1 a link, the episode matches and no earlier link
    was terminal.

    Returns the base items plus nstep_rewards (B, n, ...) (invalid links
    zeroed), nstep_valid (B, n), nstep_m (B,) chain lengths in [1, n], and
    next_feats / next_global_state / next_extras / done taken at the
    chain's end (the bootstrap state)."""
    cap = buf.capacity
    idx = _indices(buf, batch_size, generator, idx)
    ks = torch.arange(n, device=idx.device)
    chain = (idx[:, None] + ks[None, :] * stride) % cap  # (B, n)

    st = buf.storage
    t, ep, done = st["_t"][chain], st["_ep"][chain], st["done"][chain]
    ok_link = (t == t[:, :1] + ks[None, :]) & (ep == ep[:, :1])
    done_prev = torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]], dim=1)
    done_before = torch.cumsum(done_prev.to(torch.int32), dim=1) > 0
    valid = torch.cumprod((ok_link & ~done_before).to(torch.int32), dim=1).to(torch.bool)
    m = valid.sum(dim=1)  # (B,) in [1, n]
    last = torch.gather(chain, 1, (m - 1)[:, None])[:, 0]

    out = _map(lambda s: s[idx], st)
    rew = st["rewards"][chain]
    out["nstep_rewards"] = torch.where(valid.reshape(valid.shape + (1,) * (rew.dim() - 2)),
                                       rew, 0.0)
    out["nstep_valid"] = valid
    out["nstep_m"] = m.to(torch.int32)
    for k in ("next_feats", "next_global_state", "next_extras"):
        if k in st:
            out[k] = _map(lambda s: s[last], st[k])
    out["done"] = st["done"][last]
    return out


def clear(buf: ReplayBuffer) -> ReplayBuffer:
    """Empty the buffer (the reference clears its memory every 200
    episodes, gru.py:1258-1260)."""
    return ReplayBuffer(buf.storage, 0, 0)
