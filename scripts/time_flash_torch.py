"""Time the port's flash-attention kernels on the card: K2 (forward) and
the backward of ``avsum_torch`` at the summarize, train and hour step
shapes, CUDA events, float32, TF32 off.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python scripts/time_flash_torch.py [--label NAME]

Prints one JSON line per kernel and shape: the median, min and max ms per
launch over 5 rounds (``chip_smoke.compare_ms``) and the max |difference|
from the kernel's plain version on the same inputs (the run fails past
chip_smoke's tolerances), with ``label``. "bwd" is the whole backward:
the fused kernel (``flash_bwd``) on a tree that has it, else the two
kernels ``flash_bwd_dkv`` then ``flash_bwd_dq``, so this script, copied
into an older checkout, times both designs alike. Two checkouts are
compared by running it from each in turns on one card in one command
(A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((544, 256, ("fwd",)), (1024, 256, ("fwd", "bwd")),
          (1024, 128, ("fwd", "bwd")), (7168, 256, ("fwd", "bwd")),
          (7168, 128, ("fwd", "bwd")))


def backward(att):
    """-> (kernel, plain): the whole backward of ``att`` (its
    ``ops.attention``) as functions of the backward's inputs returning
    (dq, dk, dv)."""
    if hasattr(att, "flash_bwd"):
        return att.flash_bwd, att.flash_bwd_plain

    def split(dkv, dq):
        def run(*args):
            dk, dv = dkv(*args)
            return dq(*args), dk, dv
        return run

    return (split(att.flash_bwd_dkv, att.flash_bwd_dq),
            split(att.flash_bwd_dkv_plain, att.flash_bwd_dq_plain))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from avsum_torch.ops import attention as att

    if not torch.cuda.is_available():
        print("time_flash_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    bwd_kernel, bwd_plain = backward(att)
    for s, d, kernels in SHAPES:
        qkv, mask, cot = chip_smoke._flash_case(1, s, d, seed=d)
        bwd = chip_smoke._bwd_inputs(qkv, mask, cot)
        fns = {"fwd": lambda: att.flash_attention_fwd(*bwd[:3], mask),
               "bwd": lambda: bwd_kernel(*bwd)}
        plain = {"fwd": lambda: att.attention_fwd_plain(*bwd[:3], mask),
                 "bwd": lambda: bwd_plain(*bwd)}
        errs = {}
        for name in kernels:
            tol = chip_smoke.K2_TOL if name == "fwd" else chip_smoke.B34_TOL
            got, want = fns[name](), plain[name]()
            got, want = (x if isinstance(x, tuple) else (x,)
                         for x in (got, want))
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, **tol)
            errs[name] = max((a - b).abs().max().item()
                             for a, b in zip(got, want))
            del got, want
        t = chip_smoke.compare_ms({k: fns[k] for k in kernels},
                                  iters=5 if s > 2048 else 20)
        for name, (med, lo, hi) in t.items():
            print(json.dumps({"label": args.label, "kernel": name,
                              "shape": [1, s, 4, d], "ms": med, "min_ms": lo,
                              "max_ms": hi, "max_abs_err": errs[name],
                              "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
