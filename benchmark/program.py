"""What the benchmark knows of the port it measures: its configuration
built from a configuration file, and where the reference scorer's leaves
sit among the port's parameters."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import torch


def program_leaf_map(model: dict) -> Dict[str, List[str]]:
    """The port's parameter names -> the reference leaves they hold,
    concatenated along the first axis."""
    out: Dict[str, List[str]] = {}

    def linear(prog: str, ref: str) -> None:
        out[f"{prog}.weight"] = [f"{ref}.w"]
        out[f"{prog}.bias"] = [f"{ref}.b"]

    def attention(prog: str, ref: str) -> None:
        out[f"{prog}.qkv.weight"] = [f"{ref}.{p}.w" for p in "qkv"]
        out[f"{prog}.qkv.bias"] = [f"{ref}.{p}.b" for p in "qkv"]
        linear(f"{prog}.out", f"{ref}.o")

    for m in ("visual", "audio"):
        linear(f"{m}_fc.dense", f"{m}_fc")
        if model["temporal_encoder"] == "bilstm":
            for d in ("fwd", "bwd"):
                for p in ("wi", "wh", "b"):
                    out[f"{m}_temporal.{d}.{p}"] = [f"{m}_enc.{d}.{p}"]
        else:
            for i in range(model["temporal_layers"]):
                prog, ref = f"{m}_temporal.blocks.{i}", f"{m}_enc.{i}"
                for n, r in (("norm_0", "ln0"), ("norm_1", "ln1")):
                    out[f"{prog}.{n}.weight"] = [f"{ref}.{r}.g"]
                    out[f"{prog}.{n}.bias"] = [f"{ref}.{r}.b"]
                attention(f"{prog}.attention", ref)
                linear(f"{prog}.dense_0", f"{ref}.ff0")
                linear(f"{prog}.dense_1", f"{ref}.ff1")
    attention("cross_attention", "fusion")
    linear("scorer_hidden", "head")
    linear("scorer_out", "out")
    return out


def program_state(leaves: Dict[str, torch.Tensor], model: dict
                  ) -> Dict[str, torch.Tensor]:
    return {prog: torch.cat([leaves[r] for r in refs])
            for prog, refs in program_leaf_map(model).items()}


def leaf_norms(tensors: Dict[str, torch.Tensor], model: dict,
               leaf_shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, float]:
    """Each reference leaf's norm, out of the port's tensors by name."""
    out = {}
    for prog, refs in program_leaf_map(model).items():
        parts = torch.split(tensors[prog], [leaf_shapes[r][0] for r in refs])
        for ref, part in zip(refs, parts):
            out[ref] = float(part.double().norm())
    return out


def program_config(config: dict):
    """The port's Config from the configuration file's ``program``."""
    from avsum_torch.train.config import load_config

    overrides = [f"{section}.{key}={json.dumps(value)}"
                 for section, keys in config["program"].items()
                 for key, value in keys.items()]
    return load_config(None, overrides)
