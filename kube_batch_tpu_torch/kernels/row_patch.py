"""K9 · row_patch: the batched row scatter of one incremental pack
(CUDA C++, `csrc/row_patch.cu`).

Replaces kube_batch_tpu/cache/incremental.py · _row_patch: for every
row-patched snapshot field, write the host array's dirty rows into the
device buffer at their row indices, in ONE launch for the whole dirty
set.  The wrapper takes the host arrays and the padded row indices, and
writes the launch's field table, the indices and the rows — gathered by
`np.take` straight out of the host arrays — into one slot of a ring of
pinned, mapped host buffers it keeps per device (RING_SLOTS slots, each
grown to the largest payload seen).  Nothing is zero-filled, gathered
into an intermediate array or copied twice on the host.  A slot is
rewritten only after the event recorded behind the last launch that read
it has completed.  The kernel reads the slot straight over the host link
(zero-copy), so a patch is one launch and no device staging; on an H100
this was faster by events than one copy into a device buffer followed by
the launch (PERF.md).  What bounds the kernel and its design are noted in
the source.

The caller pads each field's row indices to a bucket by repeating its
first row (as the reference's `_upload` does), so duplicate writes carry
the same value.  The wrapper runs the plain version for CPU tensors and
launches the kernel for CUDA tensors; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from kube_batch_tpu_torch.kernels import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# int64 words a table entry: dst, buffer rows, row bytes, rows, idx off,
# val off, unit bytes, first unit
_ENTRY = 8
MAX_FIELDS = 60      # entries a launch's parameters carry (csrc/row_patch.cu)
RING_SLOTS = 2
MIN_SLOT = 1 << 16   # bytes of a slot's first allocation


def row_patch_plain(bufs, host_arrays, rows) -> None:
    for buf, h, r in zip(bufs, host_arrays, rows):
        idx = np.asarray(r, np.int64)
        buf[torch.from_numpy(idx).to(buf.device)] = torch.from_numpy(
            np.ascontiguousarray(h[idx])).to(buf.device)


def layout(bufs, host_arrays, rows) -> tuple[list, int, int]:
    """(table entries, staged bytes, copy units) of one launch: the table,
    then per field its int32 indices and its rows of values, each 16-byte
    aligned; a field copies in units of gcd(row bytes, 16, the buffer's
    address) bytes, numbered across fields from 0."""
    n = len(bufs)
    if n > MAX_FIELDS:
        raise ValueError(f"row_patch: at most {MAX_FIELDS} fields a launch, got {n}")
    off = (n * _ENTRY * 8 + 15) & ~15
    entries, units = [], 0
    for buf, h, r in zip(bufs, host_arrays, rows):
        if h.shape != buf.shape or h.dtype.itemsize != buf.dtype.itemsize \
                or not h.flags.c_contiguous or not buf.is_contiguous():
            raise ValueError("row_patch: a host array does not match its buffer")
        k = len(r)
        row_bytes = h.nbytes // h.shape[0]
        dst = buf.data_ptr()
        unit = math.gcd(row_bytes, 16, dst)
        val_off = (off + 4 * k + 15) & ~15
        entries.append((dst, h.shape[0], row_bytes, k, off, val_off, unit, units))
        off = (val_off + k * row_bytes + 15) & ~15
        units += k * (row_bytes // unit)
    return entries, off, units


def stage_into(slot: np.ndarray, entries, host_arrays, rows) -> None:
    """Write one launch's staged bytes into `slot` (u8, at least the
    layout's bytes, a multiple of 16): the table in place, each field's
    indices, and its rows gathered from the host array into their place
    (one typed view of the slot per dtype, so a field costs two copies
    into views and no allocation)."""
    slot[: len(entries) * _ENTRY * 8].view(np.int64)[:] = np.ravel(entries)
    i32 = slot.view(np.int32)
    typed = {}
    for (_, _, row_bytes, k, idx_off, val_off, _, _), h, r in zip(entries, host_arrays, rows):
        i32[idx_off >> 2: (idx_off >> 2) + k] = r
        t = typed.get(h.dtype)
        if t is None:
            t = typed[h.dtype] = slot.view(h.dtype)
        size = h.dtype.itemsize
        at = val_off // size
        # mode="clip" writes into `out` unbuffered; kb_row_patch refuses an
        # index outside its buffer before anything launches
        h.take(r, axis=0, mode="clip",
               out=t[at: at + k * (row_bytes // size)].reshape((k,) + h.shape[1:]))


class _Slot:
    """Pinned, mapped host bytes and the event behind the last launch that
    read them."""

    def __init__(self, dev, nbytes: int) -> None:
        host, mapped, event = _P(), _P(), _P()
        with torch.cuda.device(dev):
            build.check(_fn("kb_row_patch_slot")(nbytes, ctypes.byref(host),
                                                 ctypes.byref(mapped), ctypes.byref(event)),
                        "row_patch slot")
        self.nbytes, self.host, self.mapped, self.event = nbytes, host.value, mapped.value, event
        self.view = np.ctypeslib.as_array(
            ctypes.cast(self.host, ctypes.POINTER(ctypes.c_uint8)), shape=(nbytes,))

    def free(self) -> None:
        build.check(_fn("kb_row_patch_slot_free")(self.host, self.event), "row_patch slot")


class _Ring:
    def __init__(self, dev) -> None:
        self.dev, self.slots, self.next = dev, [None] * RING_SLOTS, 0

    def take(self, nbytes: int) -> _Slot:
        """The next slot, its last reader finished, holding `nbytes`."""
        i = self.next
        self.next = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None:
            build.check(_fn("kb_row_patch_wait")(slot.event), "row_patch wait")
            if slot.nbytes >= nbytes:
                return slot
            slot.free()
            nbytes = max(nbytes, 2 * slot.nbytes)
        slot = self.slots[i] = _Slot(self.dev, (max(nbytes, MIN_SLOT) + 4095) & ~4095)
        return slot


_rings: dict = {}
_SIGNATURES = {
    "kb_row_patch": [_P, _I, _L, _P, _P, _P],
    "kb_row_patch_slot": [_L, _P, _P, _P],
    "kb_row_patch_slot_free": [_P, _P],
    "kb_row_patch_wait": [_P],
}


def _fn(name: str):
    return build.function("row_patch", name, _SIGNATURES[name])


def ring_key(dev) -> int:
    """The card's index (`cuda` alone: the current card's)."""
    return torch.cuda.current_device() if dev.index is None else dev.index


def ring(dev) -> _Ring:
    key = ring_key(dev)
    r = _rings.get(key)
    if r is None:
        r = _rings[key] = _Ring(dev)
    return r


def row_patch(bufs: list, host_arrays: list, rows: list) -> None:
    """In place: `bufs[i][rows[i]] = host_arrays[i][rows[i]]` for every
    field i.  `bufs` are contiguous tensors of one device, `host_arrays`
    C-contiguous numpy arrays of the same shapes and item sizes, `rows`
    int32 numpy arrays in [0, len(buf))."""
    if not bufs:
        return
    dev = bufs[0].device
    if dev.type == "cpu":
        return row_patch_plain(bufs, host_arrays, rows)
    if dev.type != "cuda":
        raise RuntimeError(f"row_patch: unsupported device {dev}")
    if any(b.device != dev for b in bufs):
        raise ValueError("row_patch: buffers must lie on one device")
    entries, nbytes, units = layout(bufs, host_arrays, rows)
    if units == 0:
        return
    slot = ring(dev).take(nbytes)
    stage_into(slot.view, entries, host_arrays, rows)
    err = _fn("kb_row_patch")(slot.host, len(bufs), units, slot.mapped, slot.event,
                              build.stream_handle(dev))
    if err == -2:
        raise IndexError("row_patch: a row index lies outside its buffer")
    build.check(err, "row_patch")
    row_patch.launches += 1


row_patch.launches = 0
