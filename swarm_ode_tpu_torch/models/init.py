"""flax.linen.Dense's initialisation for torch Linear layers."""
from __future__ import annotations

import math

import torch
from torch import nn


def dense_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draws every Linear layer of `module` as flax's `Dense` initialises it:
    the kernel from `lecun_normal` (a normal truncated to two standard
    deviations, std sqrt(1/fan_in) / 0.87962566 so that the truncated draw
    has std sqrt(1/fan_in)), the bias zeros. The draws come from
    `generator`, which lies on the parameters' device. Returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def orthogonal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Draws `weight` as flax's `orthogonal()` initialiser draws a kernel: the
    Q of a QR decomposition of a standard normal matrix, its columns' signs
    set by R's diagonal (a Haar-distributed orthogonal matrix; the torch
    weight is the flax kernel transposed, orthogonal alike)."""
    rows, cols = weight.shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    device=weight.device, dtype=weight.dtype)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    with torch.no_grad():
        weight.copy_(q.T if rows < cols else q)
    return weight


def recurrent_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """dense_init_, then every recurrent kernel (a Linear whose `recurrent`
    attribute is set) drawn by `orthogonal_`, as flax's GRUCell and
    OptimizedLSTMCell draw them; biases stay zero. Returns the module."""
    dense_init_(module, generator)
    for m in module.modules():
        if isinstance(m, nn.Linear) and getattr(m, "recurrent", False):
            orthogonal_(m.weight, generator)
    return module
