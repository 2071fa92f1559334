"""``python -m avsum_torch.bench {e2e,hour,train-hour,parity} [--device
cpu] [--config C.yaml] [--set a.b=c ...] [--seed N] [--weights W.pt]``;
``python -m avsum_torch.bench {parity-merge,parity-rebuild} --work DIR``."""

from __future__ import annotations

import argparse
import logging
import sys

from avsum_torch.bench import (
    e2e,
    hour,
    parity,
    parity_merge,
    parity_rebuild,
    train_hour,
)

COMMANDS = {"e2e": e2e, "hour": hour, "train-hour": train_hour,
            "parity": parity, "parity-merge": parity_merge,
            "parity-rebuild": parity_rebuild}


def main(argv=None) -> int:
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
    ap = argparse.ArgumentParser(prog="python -m avsum_torch.bench",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for name, module in COMMANDS.items():
        parents = [common] if getattr(module, "USES_DEVICE", True) else []
        module.add_arguments(sub.add_parser(
            name, parents=parents, help=module.__doc__.splitlines()[0]))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(levelname)s %(name)s: %(message)s")
    return COMMANDS[args.command].run(args)


if __name__ == "__main__":
    sys.exit(main())
