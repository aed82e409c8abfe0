"""Device-time marks: wrapper of ``csrc/obs_mark.cu``.

Replaces no TPU kernel (the JAX package times spans on the host).  A
:class:`MarkRing` is the span tracer's stamp source on a card
(:mod:`repro_torch.obs.trace`): :meth:`MarkRing.mark` enqueues a
one-thread kernel on the current stream that writes the GPU's
``%globaltimer`` (ns) into a slot of a page-locked, host-mapped ring, and
:meth:`MarkRing.read` reads the slot on the host, which is only sound
after a synchronisation that covers the mark (0: not written yet).  A
mark made inside a CUDA graph capture (``keep=True``) holds its slot for
good and rewrites it at every replay.

The library is built and loaded at the first mark, so only a run with a
tracer on a card ever builds it; nothing here runs at import time.
There is no plain version: the CPU has no device clock, and a tracer on
CPU tensors times its spans on the host.
"""
from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

#: the marks' kernels, ``obs_mark_<kind>``, in the C entry point's order
KINDS = ("span", "round_begin", "draft_begin", "round_end",
         "rollback_begin", "rollback_end")
_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


class MarkRing:
    """``n`` slots of device-written stamps on ``device``'s streams."""

    def __init__(self, device, n: int = 4096):
        self.device = torch.device(device)
        self.n = n
        self.launches = 0
        self._host = None            # numpy view of the ring (uint64)
        self._dev = None             # the ring's device address
        self._launch = None          # the C entry point obs_mark
        self._free = collections.deque(range(n))
        self._kept: set = set()

    def _ring(self):
        if self._host is None:
            lib = _build.load_library("obs_mark")
            lib.obs_ring_alloc.argtypes = [ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_void_p),
                                           ctypes.POINTER(ctypes.c_void_p)]
            lib.obs_ring_alloc.restype = ctypes.c_int
            host, dev = ctypes.c_void_p(), ctypes.c_void_p()
            _build.check(lib.obs_ring_alloc(self.n, ctypes.byref(host),
                                            ctypes.byref(dev)),
                         "obs_ring_alloc")
            self._host = np.ctypeslib.as_array(
                (ctypes.c_uint64 * self.n).from_address(host.value))
            self._dev = dev.value
            self._launch = _build.bind("obs_mark", "obs_mark", _ARGS)
        return self._host

    def mark(self, kind: str, keep: bool = False) -> int | None:
        """Enqueue mark ``kind`` on the current stream; its slot, or None
        when every slot awaits a read."""
        self._ring()
        if not self._free:
            return None
        slot = self._free.popleft()
        if keep:
            self._kept.add(slot)
        rc = self._launch(KINDS.index(kind), self._dev, slot,
                          torch.cuda.current_stream(self.device).cuda_stream)
        _build.check(rc, f"obs_mark_{kind}")
        self.launches += 1
        return slot

    def read(self, slot: int) -> int:
        """The slot's stamp (ns of ``%globaltimer``), 0 if not written."""
        return int(self._ring()[slot])

    def release(self, slot: int) -> None:
        """Clear a read slot; one not held by a graph is free again."""
        self._ring()[slot] = 0
        if slot not in self._kept:
            self._free.append(slot)
