"""Process startup (``avsum_tpu/parallel/multihost.py``).

``torchrun`` starts one process per rank and hands each its rank and the
rendezvous address in the environment; :func:`initialize` turns that (or
explicit arguments) into the default process group, and does nothing for
a single process. :class:`Ranks` starts such a world itself, on
localhost, for tests and ``chip_smoke.py``: ``world`` spawned processes
that run the functions they are sent, so one world serves many calls.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("avsum_torch.multihost")

# a collective that waits longer than this raises
TIMEOUT = datetime.timedelta(seconds=300)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> bool:
    """Join the default process group. With no arguments the rank, the
    world size and the address come from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a world
    of one process (or no such environment) is left uninitialized. A
    second call does nothing. -> True when this call joined a group."""
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        dist.init_process_group(backend, timeout=TIMEOUT)
    else:
        if (num_processes or 1) <= 1:
            return False
        dist.init_process_group(backend, f"tcp://{coordinator_address}",
                                timeout=TIMEOUT, world_size=num_processes,
                                rank=process_id)
    log.info("rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
             backend)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's share of a batch axis split over the processes."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, backend: str, port: int, tasks,
               results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, f"tcp://127.0.0.1:{port}",
                            timeout=TIMEOUT, world_size=world, rank=rank)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(*args)))
            except Exception:  # reported to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` spawned processes in one process group on localhost.

    ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn`` must be
    importable by name, its results picklable) and returns the results in
    rank order; a rank that raises makes ``run`` raise with its
    traceback. Use as a context manager; ``close`` stops every process.
    """

    def __init__(self, world: int, backend: str = "gloo",
                 timeout: float = 600.0):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, backend, port,
                                         self._tasks[r], self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args: Any) -> List[Any]:
        for q in self._tasks:
            q.put((fn, args))
        out: List[Any] = [None] * self.world
        errors = []
        deadline = time.monotonic() + self.timeout
        for _ in range(self.world):
            while True:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs
                            if p.exitcode is not None]
                    if dead or time.monotonic() > deadline:
                        self.close()
                        raise RuntimeError(
                            f"{fn.__name__}: a rank exited ({dead}) or did "
                            f"not answer in {self.timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed\n" + "\n".join(errors))
        return out

    def close(self) -> None:
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(p.is_alive()
                                                  for p in self._procs):
            try:  # drained, so no rank blocks on a result nobody reads
                self._results.get(timeout=0.1)
            except queue.Empty:
                pass
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

