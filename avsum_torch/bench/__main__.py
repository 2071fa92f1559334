"""The port's measurement entry points: ``python -m avsum_torch.bench CMD``.

``CMD`` is one of e2e, hour, train-hour, parity, ppep, pp-equality,
deep-pp-curve, embed-sweep or embed-ab, each with ``[--device cpu]
[--config C.yaml] [--set a.b=c ...] [--seed N] [--weights W.pt]``, or
parity-merge / parity-rebuild with ``--work DIR``."""

from __future__ import annotations

import argparse
import logging
import sys

from avsum_torch.bench import (
    deep_pp_curve,
    e2e,
    embed_ab,
    embed_sweep,
    hour,
    parity,
    parity_merge,
    parity_rebuild,
    pp_equality,
    ppep,
    train_hour,
)

COMMANDS = {"e2e": e2e, "hour": hour, "train-hour": train_hour,
            "parity": parity, "parity-merge": parity_merge,
            "parity-rebuild": parity_rebuild, "ppep": ppep,
            "pp-equality": pp_equality, "deep-pp-curve": deep_pp_curve,
            "embed-sweep": embed_sweep, "embed-ab": embed_ab}


def _common() -> argparse.ArgumentParser:
    """The flags every command that runs on a device takes (a new parser
    for each command: one whose own flag has a common name, as
    deep-pp-curve's --config and --seed, takes that flag's place)."""
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    common.add_argument("--config", default=None,
                        help="YAML config under the bench's own settings")
    common.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override, after the bench's own")
    common.add_argument("--seed", type=int, default=0,
                        help="the random weights' seed")
    common.add_argument("--weights", default=None,
                        help="a .pt of state_dicts (python -m "
                             "avsum_torch.convert)")
    return common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m avsum_torch.bench",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for name, module in COMMANDS.items():
        parents = [_common()] if getattr(module, "USES_DEVICE", True) else []
        module.add_arguments(sub.add_parser(
            name, parents=parents, help=module.__doc__.splitlines()[0],
            conflict_handler="resolve"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    return COMMANDS[args.command].run(args)


if __name__ == "__main__":
    sys.exit(main())
