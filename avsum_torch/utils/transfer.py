"""Host <-> device copies that do not make the host wait for the device.

A copy from pageable host memory, or any copy without ``non_blocking``,
waits for every kernel already queued on the stream, which would put the
host's dispatch loop in lockstep with the device. These helpers go through
pinned memory and copy asynchronously on a CUDA device; on the CPU they
are plain conversions (the work there is synchronous anyway). Where the
host does wait for the device (an event's synchronize), the wait is the
span ``avsum.device_wait``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

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

    def upload(self, nbytes: int,
               fill: Callable[[np.ndarray], None]) -> torch.Tensor:
        """``fill`` writes ``nbytes`` bytes into the uint8 array it is
        given -> those bytes as a uint8 tensor on the device."""
        if self.device.type != "cuda":
            host = np.empty(nbytes, np.uint8)
            fill(host)
            return torch.from_numpy(host)
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            with annotate("avsum.device_wait"):
                self._events[i].synchronize()
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        host = self._bufs[i][:nbytes]
        fill(host.numpy())
        out = host.to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record(torch.cuda.current_stream(self.device))
        return out
