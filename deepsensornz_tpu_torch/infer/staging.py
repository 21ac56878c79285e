"""A persistent pinned staging ring for host-to-card uploads.

``t.to(device)`` from pageable host memory has the CUDA driver copy the
tensor through its own small pinned buffer on the calling thread, one
memcpy at a time: the host is blocked for the whole transfer and the link
waits for each memcpy. :class:`StagingRing` holds a few pinned slabs
instead, allocated once (at the first upload) and reused by every later
one. An upload lays its leaves one after another in a byte stream, each
from an offset that is a multiple of :data:`ALIGN`, and cuts the stream
into slab-sized windows (:func:`plan`): a leaf larger than a slab is cut
into pieces, smaller leaves share a slab. Each window is filled into the
next free slab by the ring's own host threads, a part of a piece each
(``np.copyto`` of bytes: the threads then sleep on their queue, where
torch's OpenMP workers would spin after each copy and hold the host's
cores from the request's next steps); a piece with a cast is one torch
``copy_``, which casts as it copies. The next slab's parts are queued
before the calling thread waits for this slab's, so the threads never
wait between slabs. Once a slab is full, each of its pieces goes to its
slice of the leaf's device tensor by one ``non_blocking`` copy on the
current stream, so work queued behind the upload on that stream sees it.
An event recorded after a slab's copies is waited on only when that slab
is to be filled again: the DMA of one slab overlaps the fill of the next.

The device tensors are contiguous and hold the values ``t.to(dtype)``
gives, bit for bit; the source tensors are read only while ``upload``
runs. Counters: ``predict_grid.upload_staged_bytes`` (bytes through the
ring) and ``predict_grid.upload_slab_waits`` (fills that waited for a
slab's copy to finish).
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from deepsensornz_tpu_torch.perf import spans

ALIGN = 256  # each leaf's offset in the stream: any dtype can view its slab bytes
SLAB_BYTES = 32 << 20
N_SLABS = 4  # 128 MiB pinned in all, whatever the upload's size
PART_BYTES = 1 << 20  # the least a fill thread copies at a time


def plan(sizes: Sequence[int], slab_bytes: int = SLAB_BYTES,
         align: int = ALIGN) -> list[list[tuple[int, int, int, int]]]:
    """The slabs of an upload of leaves of ``sizes`` bytes: the leaves laid
    one after another in one byte stream, each from a multiple of
    ``align``, the stream cut every ``slab_bytes``. One list per slab, in
    stream order, of its pieces ``(leaf, start in the leaf, start in the
    slab, bytes)``; a leaf of 0 bytes has none. Every byte of every leaf
    is in exactly one piece, and each leaf's pieces run in order."""
    if slab_bytes % align:
        raise ValueError(f"slab_bytes {slab_bytes} is not a multiple of align {align}")
    slabs: list[list[tuple[int, int, int, int]]] = []
    pos = 0
    for leaf, n in enumerate(sizes):
        pos = -(-pos // align) * align
        done = 0
        while done < n:
            slab, off = divmod(pos, slab_bytes)
            take = min(n - done, slab_bytes - off)
            if slab == len(slabs):
                slabs.append([])
            slabs[slab].append((leaf, done, off, take))
            done += take
            pos += take
    return slabs


class StagingRing:
    """``n_slabs`` host slabs of ``slab_bytes`` each, pinned on a CUDA
    host, and as many fill threads as torch's intra-op threads, made at
    the first :meth:`upload`. A lock serialises the uploads: a ring may be
    shared between threads. ``n_slabs`` is at least 2: one fills while
    the one before it is sent."""

    def __init__(self, slab_bytes: int = SLAB_BYTES, n_slabs: int = N_SLABS):
        if n_slabs < 2:
            raise ValueError(f"a ring needs at least 2 slabs, got {n_slabs}")
        self.slab_bytes = slab_bytes
        self.n_slabs = n_slabs
        self.slabs = None
        self._threads = 0
        self._pool: ThreadPoolExecutor | None = None
        self._events: list = [None] * n_slabs
        self._next = 0
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        """Host bytes the ring holds (0 before its first upload)."""
        return 0 if self.slabs is None else self.slabs.numel()

    def upload(self, leaves: Sequence[tuple[torch.Tensor, torch.dtype]],
               device: torch.device) -> list[torch.Tensor]:
        """Each host tensor of ``leaves`` as a contiguous tensor of its
        paired dtype on ``device`` (module docstring)."""
        srcs = [t.contiguous().view(-1) for t, _ in leaves]
        outs = [torch.empty(t.shape, dtype=dt, device=device) for t, dt in leaves]
        sizes = [o.numel() * o.element_size() for o in outs]
        raw = [s.view(torch.uint8).numpy() if s.dtype == o.dtype else None
               for s, o in zip(srcs, outs)]
        with self._lock:
            if self.slabs is None:
                with torch.inference_mode(False):
                    self.slabs = torch.empty((self.n_slabs, self.slab_bytes), dtype=torch.uint8,
                                             pin_memory=device.type == "cuda")
                self._threads = torch.get_num_threads()
                self._pool = ThreadPoolExecutor(self._threads)
            slabs = self.slabs.numpy()
            filling = collections.deque()  # (slab, its pieces, its parts' futures)
            for pieces in plan(sizes, self.slab_bytes):
                k = self._next
                self._next = (k + 1) % self.n_slabs
                event = self._events[k]
                if event is not None and not event.query():
                    spans.count("predict_grid.upload_slab_waits")
                    event.synchronize()
                parts = []
                for leaf, start, off, n in pieces:
                    if raw[leaf] is None:  # a cast: torch's copy
                        size = outs[leaf].element_size()
                        self.slabs[k, off:off + n].view(outs[leaf].dtype).copy_(
                            srcs[leaf][start // size:(start + n) // size])
                        continue
                    step = max(PART_BYTES, -(-n // self._threads))
                    parts += [self._pool.submit(np.copyto, slabs[k, off + a:off + min(a + step, n)],
                                                raw[leaf][start + a:start + min(a + step, n)])
                              for a in range(0, n, step)]
                filling.append((k, pieces, parts))
                if len(filling) == 2:
                    self._send(*filling.popleft(), outs, device)
            while filling:
                self._send(*filling.popleft(), outs, device)
        spans.count("predict_grid.upload_staged_bytes", sum(sizes))
        return outs

    def _send(self, k: int, pieces, parts, outs, device) -> None:
        """Once slab ``k``'s parts are copied, each of its pieces to its
        slice of its leaf's device tensor, then slab ``k``'s event."""
        for f in parts:
            f.result()
        for leaf, start, off, n in pieces:
            size = outs[leaf].element_size()
            outs[leaf].view(-1)[start // size:(start + n) // size].copy_(
                self.slabs[k, off:off + n].view(outs[leaf].dtype), non_blocking=True)
        if device.type == "cuda":
            if self._events[k] is None:
                self._events[k] = torch.cuda.Event()
            self._events[k].record(torch.cuda.current_stream(device))
