"""K9 · row_patch: the batched row scatter of one incremental pack
(CUDA C++, `csrc/row_patch.cu`).

Replaces kube_batch_tpu/cache/incremental.py · _row_patch: for every
row-patched snapshot field, write the values of its dirty rows into the
device buffer at their row indices, in ONE launch for the whole dirty
set.  The wrapper stages every field's table entry, row indices and row
values in one pinned host buffer, ships it with one non-blocking copy on
the current stream and launches the kernel on the same stream.  What
bounds the kernel and its design are noted in the source.

The caller pads each field's row indices to a bucket by repeating its
first row with that row's value (as the reference's `_upload` does), so
duplicate writes are identical.  The wrapper runs the plain version for
CPU tensors and launches the kernel for CUDA tensors; it never falls
back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kube_batch_tpu_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ENTRY = 5   # int64 words per table entry: dst, row bytes, rows, idx off, val off


def _align(n: int, to: int = 16) -> int:
    return (n + to - 1) // to * to


def row_patch_plain(bufs, rows, vals) -> None:
    for buf, r, v in zip(bufs, rows, vals):
        idx = torch.from_numpy(np.asarray(r, np.int64)).to(buf.device)
        buf[idx] = torch.from_numpy(np.ascontiguousarray(v)).to(buf.device)


def stage(bufs, rows, vals) -> np.ndarray:
    """The staged bytes of one launch (u8): the field table, then each
    field's int32 row indices and its rows of values, 16-byte aligned."""
    n = len(bufs)
    off = _align(n * _ENTRY * 8)
    layout = []
    for buf, r, v in zip(bufs, rows, vals):
        k = len(r)
        row_bytes = buf[0].numel() * buf.element_size() if buf.ndim > 1 \
            else buf.element_size()
        if v.dtype.itemsize * (v.size // max(k, 1)) != row_bytes or v.shape[0] != k:
            raise ValueError("row_patch: values do not match the buffer's rows")
        idx_off = off
        off = _align(off + 4 * k)
        val_off = off
        off = _align(off + k * row_bytes)
        layout.append((buf.data_ptr(), row_bytes, k, idx_off, val_off))
    out = np.zeros(off, np.uint8)
    table = out[: n * _ENTRY * 8].view(np.int64).reshape(n, _ENTRY)
    for i, (entry, r, v) in enumerate(zip(layout, rows, vals)):
        table[i] = entry
        _, row_bytes, k, idx_off, val_off = entry
        out[idx_off: idx_off + 4 * k] = np.asarray(r, np.int32).view(np.uint8)
        out[val_off: val_off + k * row_bytes] = (
            np.ascontiguousarray(v).reshape(-1).view(np.uint8))
    return out


def row_patch(bufs: list, rows: list, vals: list) -> None:
    """In place: `bufs[i][rows[i]] = vals[i]` for every field i.  `bufs`
    are contiguous tensors of one device, `rows` int32 numpy arrays in
    [0, len(buf)), `vals` numpy arrays of the buffer's dtype with one row
    per index."""
    if not bufs:
        return
    dev = bufs[0].device
    if dev.type == "cpu":
        return row_patch_plain(bufs, rows, vals)
    if dev.type != "cuda":
        raise RuntimeError(f"row_patch: unsupported device {dev}")
    for b in bufs:
        if b.device != dev or not b.is_contiguous():
            raise ValueError("row_patch: buffers must be contiguous, on one device")
    staged = stage(bufs, rows, vals)
    pinned = torch.empty(staged.shape[0], dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = staged
    on_card = pinned.to(dev, non_blocking=True)
    fn = build.library("row_patch").kb_row_patch
    fn.argtypes = [_P, _I, _L, _P]
    fn.restype = ctypes.c_int
    err = fn(build.ptr(on_card), len(bufs), max(len(r) for r in rows),
             build.stream_handle(dev))
    build.check(err, "row_patch")
    row_patch.launches += 1


row_patch.launches = 0
