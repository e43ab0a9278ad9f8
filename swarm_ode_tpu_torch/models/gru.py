"""Recurrent models: the heterogeneous graph-GRU Q-network and the sequence
trajectory baselines.

Counterpart of `swarm_ode_tpu/models/gru.py` (HeteroGraphGRUNetwork :19,
_SeqDecoder :65, GRUTrajectoryPredictor :74, LSTMTrajectoryPredictor :96,
PositionOnlyGRU :116, PositionOnlyLSTM :134; reference gru.py:66-180,
train_baselines.py:128-335). The cells are flax's, written out:

- `GRUCell` (flax.linen.GRUCell): input layers `ir`, `iz`, `in` with a
  bias, recurrent layers `hr`, `hz` without and `hn` with one;
  r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
  n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h.
- `LSTMCell` (flax.linen.OptimizedLSTMCell): input layers `ii`, `if`,
  `ig`, `io` without a bias, recurrent layers `hi`, `hf`, `hg`, `ho` with
  one; c' = f * c + i * g, h' = o * tanh(c').

torch.nn.GRU and LSTM order and bias their gates otherwise. Submodule names
are the flax tree's keys (`in` and `if` are Python keywords, so they are
registered by name), so `convert.flax_params_to_state_dict` carries flax
parameters over. `init_` draws as flax does: lecun-normal input kernels,
orthogonal recurrent kernels, zero biases (models/init.recurrent_init_).

A sequence model takes (B, T, N, D), runs the B*N agent sequences through
each layer with the carry starting at zeros (flax's nn.RNN), and decodes
the last step. A layer's input projections are one product over all T
steps; only the recurrent products run step by step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from swarm_ode_tpu_torch.graphs.hetero import HeteroGraph
from swarm_ode_tpu_torch.models.hetero_gnn import HeteroGNNEncoder, QHead
from swarm_ode_tpu_torch.models.init import recurrent_init_


def _recurrent(in_features: int, out_features: int, bias: bool) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, bias=bias)
    layer.recurrent = True  # drawn orthogonal by recurrent_init_
    return layer


class GRUCell(nn.Module):
    """flax.linen.GRUCell: forward(h, x) -> h'."""

    def __init__(self, in_features: int, hidden_dim: int):
        super().__init__()
        for gate in ("r", "z", "n"):
            self.add_module(f"i{gate}", nn.Linear(in_features, hidden_dim))
        self.hr = _recurrent(hidden_dim, hidden_dim, bias=False)
        self.hz = _recurrent(hidden_dim, hidden_dim, bias=False)
        self.hn = _recurrent(hidden_dim, hidden_dim, bias=True)
        self.hidden_dim = hidden_dim

    def inputs(self, x):
        """The input layers' outputs (ir, iz, in) of x (..., in_features)."""
        return tuple(self._modules[f"i{gate}"](x) for gate in ("r", "z", "n"))

    def step(self, h, xi):
        """h' from the carry h and the input layers' outputs `xi`."""
        xr, xz, xn = xi
        r = torch.sigmoid(xr + self.hr(h))
        z = torch.sigmoid(xz + self.hz(h))
        n = torch.tanh(xn + r * self.hn(h))
        return (1.0 - z) * n + z * h

    def zero_carry(self, like: torch.Tensor):
        return like.new_zeros(like.shape[:-1] + (self.hidden_dim,))

    def forward(self, h, x):
        return self.step(h, self.inputs(x))


class LSTMCell(nn.Module):
    """flax.linen.OptimizedLSTMCell: forward((c, h), x) -> (c', h')."""

    def __init__(self, in_features: int, hidden_dim: int):
        super().__init__()
        for gate in ("i", "f", "g", "o"):
            self.add_module(f"i{gate}", nn.Linear(in_features, hidden_dim, bias=False))
            self.add_module(f"h{gate}", _recurrent(hidden_dim, hidden_dim, bias=True))
        self.hidden_dim = hidden_dim

    def inputs(self, x):
        """The input layers' outputs (ii, if, ig, io) of x (..., in_features)."""
        return tuple(self._modules[f"i{gate}"](x) for gate in ("i", "f", "g", "o"))

    def step(self, carry, xi):
        c, h = carry
        i, f, g, o = (self._modules[f"h{gate}"](h) + x for gate, x in zip("ifgo", xi))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def zero_carry(self, like: torch.Tensor):
        z = like.new_zeros(like.shape[:-1] + (self.hidden_dim,))
        return z, z

    def forward(self, carry, x):
        return self.step(carry, self.inputs(x))


def _output(carry) -> torch.Tensor:
    return carry[1] if isinstance(carry, tuple) else carry


def run_sequence(cell: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """flax's nn.RNN(cell) over x (S, T, D): the carry starts at zeros and
    the outputs (S, T, hidden) are the carries' h."""
    xi = cell.inputs(x)  # each (S, T, hidden)
    carry = cell.zero_carry(x[:, 0])
    outs = []
    for t in range(x.shape[1]):
        carry = cell.step(carry, tuple(p[:, t] for p in xi))
        outs.append(_output(carry))
    return torch.stack(outs, dim=1)


class _SeqDecoder(nn.Module):
    """hidden -> hidden//2 (ReLU) -> 2."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.Dense_1 = nn.Linear(hidden_dim // 2, 2)

    def forward(self, h):
        return self.Dense_1(torch.relu(self.Dense_0(h)))


class _SequencePredictor(nn.Module):
    """(B, T, N, D) -> per-agent sequences -> [encoder] -> stacked cells ->
    last step -> decoder -> (B, N, 2)."""

    cell_name = ""

    def __init__(self, cell, in_features: int, hidden_dim: int, num_layers: int,
                 encode: bool):
        super().__init__()
        if encode:
            self.encoder = nn.Linear(in_features, hidden_dim)
            in_features = hidden_dim
        for i in range(num_layers):
            self.add_module(f"{self.cell_name}_{i}",
                            cell(in_features if i == 0 else hidden_dim, hidden_dim))
        self.num_layers = num_layers
        self.decoder = _SeqDecoder(hidden_dim)

    def init_(self, generator: torch.Generator):
        return recurrent_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, N, D = x.shape
        x = x.transpose(1, 2).reshape(B * N, T, D)
        if hasattr(self, "encoder"):
            x = self.encoder(x)
        for i in range(self.num_layers):
            x = run_sequence(self._modules[f"{self.cell_name}_{i}"], x)
        return self.decoder(x[:, -1]).reshape(B, N, 2)


class GRUTrajectoryPredictor(_SequencePredictor):
    """observations (B, T, N, obs_dim) -> encoder -> stacked GRU -> last
    hidden -> positions (B, N, 2) (reference train_baselines.py:128-183)."""

    cell_name = "GRUCell"

    def __init__(self, obs_dim: int, num_agents: int, hidden_dim: int = 128,
                 num_layers: int = 2):
        super().__init__(GRUCell, obs_dim, hidden_dim, num_layers, encode=True)


class LSTMTrajectoryPredictor(_SequencePredictor):
    """(reference train_baselines.py:186-241)."""

    cell_name = "OptimizedLSTMCell"

    def __init__(self, obs_dim: int, num_agents: int, hidden_dim: int = 128,
                 num_layers: int = 2):
        super().__init__(LSTMCell, obs_dim, hidden_dim, num_layers, encode=True)


class PositionOnlyGRU(_SequencePredictor):
    """positions (B, T, N, 2) -> (B, N, 2) (reference train_baselines.py:244-288)."""

    cell_name = "GRUCell"

    def __init__(self, num_agents: int, hidden_dim: int = 64, num_layers: int = 2):
        super().__init__(GRUCell, 2, hidden_dim, num_layers, encode=False)


class PositionOnlyLSTM(_SequencePredictor):
    """(reference train_baselines.py:291-335)."""

    cell_name = "OptimizedLSTMCell"

    def __init__(self, num_agents: int, hidden_dim: int = 64, num_layers: int = 2):
        super().__init__(LSTMCell, 2, hidden_dim, num_layers, encode=False)


class HeteroGraphGRUNetwork(nn.Module):
    """Encoder -> one GRU cell per agent type (the hidden state carried by
    the caller) -> Q heads (reference gru.py:66-180), over B graphs. One
    step per call: forward(g, agv_hidden (B, A, H), picker_hidden (B, P, H))
    returns the Q-values, embeddings and the new hidden states; hidden
    states left out are zeros (the start of an episode, and a policy
    served without its history, as JAX's run_rl wraps it)."""

    def __init__(self, action_size: int, hidden_dim: int = 256, num_layers: int = 2,
                 coord_scale: float = 1.0):
        super().__init__()
        self.encoder = HeteroGNNEncoder(hidden_dim, num_layers, coord_scale)
        self.agv_gru = GRUCell(hidden_dim, hidden_dim)
        self.picker_gru = GRUCell(hidden_dim, hidden_dim)
        self.agv_head = QHead(hidden_dim, action_size)
        self.picker_head = QHead(hidden_dim, action_size)
        self.hidden_dim = hidden_dim

    def init_(self, generator: torch.Generator) -> "HeteroGraphGRUNetwork":
        return recurrent_init_(self, generator)

    def init_hidden(self, B: int, num_agvs: int,
                    num_pickers: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero hidden states (B, A, H) and (B, P, H) on the network's device
        (reference gru.py:176-180)."""
        w = self.agv_gru.hn.weight
        return w.new_zeros((B, num_agvs, self.hidden_dim)), w.new_zeros(
            (B, num_pickers, self.hidden_dim))

    def forward(self, g: HeteroGraph, agv_hidden: Optional[torch.Tensor] = None,
                picker_hidden: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        h_agv, h_pick, h_loc = self.encoder(g)
        if agv_hidden is None:
            agv_hidden = self.agv_gru.zero_carry(h_agv)
        if picker_hidden is None:
            picker_hidden = self.picker_gru.zero_carry(h_pick)
        agv_out = self.agv_gru(agv_hidden, h_agv)
        pick_out = self.picker_gru(picker_hidden, h_pick)
        return {
            "agv_q_values": self.agv_head(agv_out),
            "picker_q_values": self.picker_head(pick_out),
            "agv_embeddings": agv_out,
            "picker_embeddings": pick_out,
            "location_embeddings": h_loc,
            "agv_hidden": agv_out,
            "picker_hidden": pick_out,
        }
