"""Segment sum of edge messages: the K4 wrappers, their plan and their plain
versions.

Counterpart of `swarm_ode_tpu/ops/segment_pallas.py` (module name kept so
that a reader finds it). K4, `csrc/segment_sum.cu`, replaces the Pallas
kernel `_seg_kernel` (driven by `segment_sum_pallas`).

K4 sums in destination order. `segment_plan` sorts the entries by their
bucket, stably, and gives bucket d the range [offsets[d], offsets[d+1]) of
`row`, the rows of `data` that it adds; entries that are invalid or whose id
lies outside [0, N) sort past offsets[N] and are never read, as the Pallas
kernel's one-hot drops them. With `row` the sort order itself K4 is the
segment sum (`segment_sum_call`); with `row` the edges' sources it also
gathers the messages (`segment_sum_planned`, the GDE server's aggregation,
planned once per batch). Every bucket is summed in its entries' order, as
`index_add_` sums it on the CPU, so K4 and the plain versions agree there
bit for bit.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches K4 or raises; nothing falls back.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from swarm_ode_tpu_torch.ops import _build

# Launches of K4 (csrc/segment_sum.cu) in this process.
LAUNCHES = 0


def segment_plan(ids, valid, num_segments: int, rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination order for K4, without a host synchronisation.

    ids: (E,) int bucket of each entry; valid: (E,) bool or None; rows:
    (E,) int32 row of `data` each entry reads, or None for row k = entry k.
    Returns (row, offsets): row (E,) int32, the entries' rows sorted by
    bucket, stably; offsets (num_segments + 1,) int32, bucket d's range of
    `row`. Invalid and out-of-range entries lie at or beyond
    offsets[num_segments]."""
    keep = (ids >= 0) & (ids < num_segments)
    if valid is not None:
        keep = keep & valid
    key = torch.where(keep, ids, num_segments).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32, device=ids.device)
    offsets = torch.searchsorted(sorted_key, bounds, out_int32=True)
    row = order if rows is None else rows.index_select(0, order)
    return row.to(torch.int32), offsets


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


def segment_sum_planned_plain(data, row, offsets, mean: bool = False):
    """The plain version of `segment_sum_planned`: `index_add_` of the
    planned rows of `data` into their buckets, in plan order (it reads the
    plan's length on the host)."""
    N = offsets.shape[0] - 1
    counts = offsets.diff().long()
    bucket = torch.repeat_interleave(torch.arange(N, device=data.device), counts)
    rows = row[int(offsets[0]):int(offsets[N])].long()
    out = torch.zeros(N, data.shape[1], dtype=torch.float32, device=data.device)
    out.index_add_(0, bucket, data[rows].float())
    if mean:
        out = out / counts.clamp(min=1).to(torch.float32)[:, None]
    return out


def _check_cuda(tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")


def _launch(data, row, offsets, mean: bool):
    """K4 on checked CUDA tensors."""
    global LAUNCHES
    N, D = offsets.shape[0] - 1, data.shape[1]
    if N == 0 or D == 0:
        return torch.zeros(N, D, dtype=torch.float32, device=data.device)
    out = torch.empty(N, D, dtype=torch.float32, device=data.device)
    lib = _build.library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_segment_sum(
            data.data_ptr(), row.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            row.shape[0], N, D, int(mean), stream,
        )
    _build.check(err, "swarm_segment_sum")
    LAUNCHES += 1
    return out


def segment_sum_planned(data, row, offsets, mean: bool = False):
    """K4 for CUDA tensors, `segment_sum_planned_plain` for CPU tensors.

    data: (R, D) float32; row, offsets: a `segment_plan` whose rows lie in
    [0, R). Returns (N, D) float32, N = len(offsets) - 1: bucket d's sum of
    data[row[offsets[d]:offsets[d+1]]], divided by its length (at least 1)
    when `mean`. The offsets' values are not checked on the host (that would
    synchronise); the kernel keeps each range inside `row`."""
    if data.device.type == "cpu":
        return segment_sum_planned_plain(data, row, offsets, mean)
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be (R, D) float32, got {tuple(data.shape)} {data.dtype}")
    if row.dim() != 1 or row.dtype != torch.int32:
        raise ValueError(f"row must be (E,) int32, got {tuple(row.shape)} {row.dtype}")
    if offsets.dim() != 1 or offsets.shape[0] < 1 or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be (N + 1,) int32, got {tuple(offsets.shape)} {offsets.dtype}")
    _check_cuda([data, row, offsets])
    return _launch(data, row, offsets, mean)


def segment_sum_call(data, ids, num_segments: int, valid: Optional[torch.Tensor] = None):
    """K4 (`csrc/segment_sum.cu`) for CUDA tensors, `segment_sum_plain` for
    CPU tensors. data: (E, D) float32; ids: (E,) int32; valid: (E,) bool or
    None. Returns (num_segments, D) float32. On the card it plans the ids
    first (`segment_plan`), a sort on every call."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, ids, num_segments, valid)
    if data.dim() != 2 or data.dtype != torch.float32:
        raise ValueError(f"data must be (E, D) float32, got {tuple(data.shape)} {data.dtype}")
    E, D = data.shape
    if ids.shape != (E,) or ids.dtype != torch.int32:
        raise ValueError(f"ids must be ({E},) int32, got {tuple(ids.shape)} {ids.dtype}")
    if valid is not None and (valid.shape != (E,) or valid.dtype != torch.bool):
        raise ValueError(f"valid must be ({E},) bool, got {tuple(valid.shape)} {valid.dtype}")
    _check_cuda([data, ids] + ([] if valid is None else [valid]))
    return _launch(data, *segment_plan(ids, valid, max(num_segments, 0)), False)
