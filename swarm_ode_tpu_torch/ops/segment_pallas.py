"""Segment sum of edge messages: the K4 wrapper and its plain version.

Counterpart of `swarm_ode_tpu/ops/segment_pallas.py` (module name kept so
that a reader finds it). `segment_sum_call` wraps K4, `csrc/segment_sum.cu`,
which replaces the Pallas kernel `_seg_kernel` (driven by
`segment_sum_pallas`). `segment_sum_plain` is its plain PyTorch version.

Both drop an edge that is invalid or whose id lies outside [0, N), as the
Pallas kernel's one-hot does. The kernel adds with atomics, so its order of
summation, and with it the last bits of a bucket's sum, changes from run to
run. A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; nothing falls back.
"""
from __future__ import annotations

from typing import Optional

import torch

from swarm_ode_tpu_torch.ops import _build

# Launches of K4 (csrc/segment_sum.cu) in this process.
LAUNCHES = 0


def segment_sum_plain(data, ids, num_segments: int, valid=None):
    """(num_segments, D) float32 bucket sums of the (E, D) rows of `data`
    into the (E,) int32 `ids`; rows that are not `valid` ((E,) bool), or
    whose id is out of range, are dropped."""
    keep = (ids >= 0) & (ids < num_segments)
    if valid is not None:
        keep = keep & valid
    # Dropped rows go to one extra bucket that is cut off at the end.
    idx = torch.where(keep, ids.long(), num_segments)
    out = torch.zeros(num_segments + 1, data.shape[1], dtype=torch.float32, device=data.device)
    return out.index_add_(0, idx, data.float())[:num_segments]


def segment_sum_call(data, ids, num_segments: int, valid: Optional[torch.Tensor] = None):
    """K4 (`csrc/segment_sum.cu`) for CUDA tensors, `segment_sum_plain` for
    CPU tensors. data: (E, D) float32; ids: (E,) int32; valid: (E,) bool or
    None. Returns (num_segments, D) float32."""
    global LAUNCHES
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, num_segments, valid)
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be (E, D) float32, got {tuple(data.shape)} {data.dtype}")
    E, D = data.shape
    if ids.shape != (E,) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be ({E},) int32, got {tuple(ids.shape)} {ids.dtype}")
    if valid is not None and (valid.shape != (E,) or valid.dtype != torch.bool):
        raise ValueError(f"valid must be ({E},) bool, got {tuple(valid.shape)} {valid.dtype}")
    tensors = [data, ids] + ([] if valid is None else [valid])
    if data.device.type != "cuda" or any(t.device != data.device for t in tensors):
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    if num_segments <= 0 or D == 0:
        return torch.zeros(max(num_segments, 0), D, dtype=torch.float32, device=data.device)
    out = torch.empty(num_segments, D, dtype=torch.float32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_segment_sum(
            data.data_ptr(), ids.data_ptr(), None if valid is None else valid.data_ptr(),
            out.data_ptr(), E, D, int(num_segments), stream,
        )
    _build.check(err, "swarm_segment_sum")
    LAUNCHES += 1
    return out
