"""Numerical-safety tooling (``avsum_tpu/utils/debug.py``):

- ``checked(fn)``: ``fn`` wrapped so that a NaN or an infinity in any
  floating output raises ``FloatingPointError``. JAX's ``checkify`` also
  turns an out-of-bounds index inside compiled code into an error; in
  eager PyTorch an index out of bounds already raises on the CPU, and on
  CUDA it is a device-side assert that leaves the CUDA context unusable,
  so it is not something to provoke on the card.
- ``debug_nans(enable=True)``: while active, every operation is checked,
  as ``jax_debug_nans`` checks every primitive: a ``TorchDispatchMode``
  raises ``FloatingPointError`` naming the first operation whose floating
  output holds a NaN (outputs of uninitialized allocations such as
  ``empty`` are not values, and are skipped). It checks the backward's
  operations too: the autograd engine carries the dispatch-mode stack
  into the threads it runs a backward on (the CUDA device threads as
  well as the caller's thread on the CPU), so a NaN made by a gradient
  raises from ``backward``. Each check reads a flag back from the device,
  so it synchronizes once an operation: a debugging tool. The previous
  state is restored on exit (nested ``debug_nans(False)`` turns the
  checks off inside).
- ``assert_all_finite(tree, name)``: a host check of nested dicts (state
  dicts too), lists and tuples of tensors or arrays, naming the bad leaves
  by JAX's ``keystr`` paths (``['a'][0]``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# allocations whose contents are not values yet
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted", "resize_"}
_enabled = False  # the counterpart of the jax_debug_nans flag


def _nonfinite(t: torch.Tensor, nan_only: bool) -> bool:
    if not (torch.is_floating_point(t) or t.is_complex()) or t.numel() == 0:
        return False
    bad = torch.isnan(t) if nan_only else ~torch.isfinite(t)
    return bool(bad.any())


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _enabled and func.overloadpacket.__name__ not in _UNINITIALIZED:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and _nonfinite(t, True):
                    raise FloatingPointError(
                        f"debug_nans: {func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Check every operation's output for NaNs while active."""
    global _enabled
    prev = _enabled
    _enabled = enable
    try:
        if enable and not prev:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        _enabled = prev


def debug_nans_enabled() -> bool:
    return _enabled


def checked(fn: Callable) -> Callable:
    """``fn`` that raises ``FloatingPointError`` when a floating output
    holds a NaN or an infinity."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [path or "<output>" for path, leaf in _leaves(out)
               if isinstance(leaf, torch.Tensor) and _nonfinite(leaf, False)]
        if bad:
            raise FloatingPointError(
                f"checked: nan or inf in the output at {bad}")
        return out

    return wrapper


def _leaves(tree: Any, path: str = "") -> Iterator:
    """(keystr path, leaf) of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "pytree") -> None:
    """Host-side: raise ``FloatingPointError`` if a leaf of ``tree`` holds a
    NaN or an infinity."""
    bad: List[str] = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if _nonfinite(leaf.detach(), False):
                bad.append(path)
        elif isinstance(leaf, (np.ndarray, np.generic, float)):
            arr = np.asarray(leaf)
            if arr.dtype.kind in "fc" and not np.isfinite(arr).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"{name}: non-finite leaves at {bad}")
