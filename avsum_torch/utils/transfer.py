"""Host <-> device copies that do not make the host wait for the device.

A copy from pageable host memory, or any copy without ``non_blocking``,
waits for every kernel already queued on the stream, which would put the
host's dispatch loop in lockstep with the device. These helpers go through
pinned memory and copy asynchronously on a CUDA device; on the CPU they
are plain conversions (the work there is synchronous anyway). Where the
host does wait for the device (an event's synchronize), the wait is the
span ``avsum.device_wait``.

:class:`PinnedRing` uploads on the current stream (the summarize path's
frames). :class:`StagedUpload` uploads a set of arrays on a copy stream
of its own (the train step's batch, placed by
:func:`avsum_torch.parallel.mesh.shard_batch`): the host returns before
the copy has run, the copy runs beside the kernels queued before it, and
the current stream waits on an event of the copy stream, so whatever it
runs afterwards reads the arrays.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avsum_torch.utils.profiling import annotate


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A numpy array -> a tensor on ``device``. On a CUDA device the array
    is copied into pinned memory and uploaded asynchronously; PyTorch's
    caching host allocator keeps that block until the copy has run. On
    the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A device tensor's copy to the host, started now and read by
    :meth:`numpy`, which waits for the copy alone (the counterpart of
    ``jax.Array.copy_to_host_async``)."""

    def __init__(self, tensor: torch.Tensor):
        self._event: Optional[torch.cuda.Event] = None
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))
        else:
            self._host = tensor

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            with annotate("avsum.device_wait"):
                self._event.synchronize()
        return self._host.numpy()


class PinnedRing:
    """A few pinned host buffers, used in turn to upload byte buffers.

    Before the host refills a slot it waits on the event recorded after
    that slot's last copy, so the host runs at most ``SLOTS`` uploads
    ahead of the device and no buffer is overwritten while in flight."""

    SLOTS = 3

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._bufs: List[Optional[torch.Tensor]] = [None] * self.SLOTS
        self._events: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._next = 0

    def _take(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        """The next slot, once its last copy has run, grown to hold
        ``nbytes`` -> (its index, its first ``nbytes`` bytes)."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            with annotate("avsum.device_wait"):
                self._events[i].synchronize()
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        return i, self._bufs[i][:nbytes]

    def upload(self, nbytes: int,
               fill: Callable[[np.ndarray], None]) -> torch.Tensor:
        """``fill`` writes ``nbytes`` bytes into the uint8 array it is
        given -> those bytes as a uint8 tensor on the device."""
        if self.device.type != "cuda":
            host = np.empty(nbytes, np.uint8)
            fill(host)
            return torch.from_numpy(host)
        i, host = self._take(nbytes)
        fill(host.numpy())
        out = host.to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record(torch.cuda.current_stream(self.device))
        return out


# bytes: each array of a staging slot starts at a multiple of it, which a
# view of the slot as any dtype needs
ALIGN = 256


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def staged_nbytes(arrays: Sequence[np.ndarray]) -> int:
    """The bytes of a slot that holds ``arrays`` one after the other, each
    at an offset that is a multiple of ``ALIGN``."""
    return sum(_aligned(a.nbytes) for a in arrays)


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor over ``a``'s memory, or over a contiguous copy where torch
    cannot take its strides (negative ones)."""
    try:
        return torch.from_numpy(a)
    except ValueError:
        return torch.from_numpy(np.ascontiguousarray(a))


def stage_arrays(host: torch.Tensor, arrays: Sequence[np.ndarray]
                 ) -> List[torch.Tensor]:
    """Copy ``arrays`` (any strides) into the uint8 tensor ``host`` at the
    offsets :func:`staged_nbytes` counts -> the contiguous views of
    ``host`` that hold them, each of its array's shape and dtype.
    ``Tensor.copy_`` spreads a large copy over torch's intra-op threads."""
    views, offset = [], 0
    for a in arrays:
        src = _as_tensor(a)
        dst = host[offset:offset + a.nbytes].view(src.dtype).view(src.shape)
        dst.copy_(src)
        views.append(dst)
        offset += _aligned(a.nbytes)
    return views


class StagedUpload(PinnedRing):
    """Host arrays uploaded through the ring's pinned slots on a copy
    stream of its own; CUDA devices only.

    :meth:`upload_arrays` fills one slot with every array, enqueues their
    copies on the copy stream, records an event there and makes the
    current stream wait on it. Each tensor it returns is recorded on the
    current stream, so the caching allocator hands its block to no later
    copy before the current stream's work on it has run. Before the host
    refills a slot it waits on the event of that slot's last copy, which
    ran beside the kernels queued before it: two slots leave the host
    free to fill one while the other's copy runs."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.stream = torch.cuda.Stream(self.device)

    def upload_arrays(self, arrays: Sequence[np.ndarray]
                      ) -> List[torch.Tensor]:
        """``arrays`` as tensors on the device, ready for the current
        stream; the call returns before their copy has run."""
        i, host = self._take(staged_nbytes(arrays))
        views = stage_arrays(host, arrays)
        event = torch.cuda.Event()
        with torch.cuda.stream(self.stream):
            out = [v.to(self.device, non_blocking=True) for v in views]
            event.record(self.stream)
        self._events[i] = event
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in out:
            t.record_stream(current)
        return out
