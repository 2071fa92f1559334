"""Weight bridge: Flax param trees (nested dicts of arrays) -> the port's
state_dicts. The inverse of ``avsum_tpu/vision/port_torch.py`` and
``avsum_tpu/audio/port_vggish.py``.

- conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` [in, out] ->
  Linear ``weight`` [out, in];
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  -> ``weight``/``bias``/``running_mean``/``running_var``;
- the attention's DenseGeneral ``qkv`` kernel [E, 3, H, D] and ``out``
  kernel [H, D, E] -> Linear(E, 3E) and Linear(E, E);
- LSTM ``wi`` [F, 4H], ``wh`` [H, 4H], ``b`` [4H] keep their layout.

``python -m avsum_torch.convert --checkpoint DIR --out FILE.pt`` turns a
JAX scorer checkpoint into ``{"scorer": state_dict}`` for
``avsum_torch.cli summarize --weights FILE.pt``. That entry point reads
the checkpoint through the JAX package, so it runs only where JAX is
installed; nothing else here imports it.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value, np.float32)
    return flat


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _convert(variables: Mapping, module_name) -> Dict[str, torch.Tensor]:
    """Generic leaf conversion; ``module_name`` maps a Flax module path
    ("a/b/c") to the port's dotted module path."""
    sd: Dict[str, torch.Tensor] = {}
    flat = _flatten(variables.get("params", {}))
    stats = _flatten(variables.get("batch_stats", {}))
    for path, value in flat.items():
        mod, leaf = path.rsplit("/", 1)
        name = module_name(mod)
        if leaf == "kernel" and value.ndim == 4:
            sd[f"{name}.weight"] = _tensor(value.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and value.ndim == 2:
            sd[f"{name}.weight"] = _tensor(value.T)
        elif leaf == "scale":
            sd[f"{name}.weight"] = _tensor(value)
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
        elif leaf == "bias":
            sd[f"{name}.bias"] = _tensor(value)
        else:
            raise KeyError(f"unmapped Flax leaf {path}")
    for path, value in stats.items():
        mod, leaf = path.rsplit("/", 1)
        field = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{module_name(mod)}.{field}"] = _tensor(value)
    return sd


def _resnet_module(path: str) -> str:
    path = re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", path)
    path = path.replace("downsample_conv", "downsample.0")
    path = path.replace("downsample_bn", "downsample.1")
    return path.replace("/", ".")


def dual_backbone_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``DualBackbone`` variables {"params", "batch_stats"} -> state_dict;
    a ``ResNet50`` or ``InceptionV3`` tree alone converts the same way."""
    return _convert(variables, _resnet_module)


def tiny_backbone_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    names = {"Conv_0": "conv0", "Conv_1": "conv1", "Dense_0": "dense"}
    return _convert(variables, names.__getitem__)


def vggish_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """VGGish params -> state_dict. The port flattens its conv output in
    NHWC order, as Flax does, so ``fc1_1`` needs no row permutation."""
    return _convert({"params": params}, lambda p: p)


def attention_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MultiHeadSelfAttention params {qkv, out} -> state_dict: DenseGeneral
    kernels [E, 3, H, D] and [H, D, E] become Linear(E, 3E), Linear(E, E)."""
    qkv_k = np.asarray(params["qkv"]["kernel"], np.float32)
    out_k = np.asarray(params["out"]["kernel"], np.float32)
    e = qkv_k.shape[0]
    return {
        "qkv.weight": _tensor(qkv_k.reshape(e, -1).T),
        "qkv.bias": _tensor(np.asarray(params["qkv"]["bias"]).reshape(-1)),
        "out.weight": _tensor(out_k.reshape(-1, e).T),
        "out.bias": _tensor(np.asarray(params["out"]["bias"])),
    }


def bilstm_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """BiLSTM params {fwd, bwd: {wi, wh, b}} -> state_dict (same layout)."""
    return {f"{direction}.{leaf}": _tensor(np.asarray(value))
            for direction, leaves in params.items()
            for leaf, value in leaves.items()}


def scorer_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AVScorer params (bilstm encoder, self fusion) -> state_dict."""
    params = dict(params)
    sd: Dict[str, torch.Tensor] = {}
    for name, value in attention_from_flax(params.pop("cross_attention")).items():
        sd[f"cross_attention.{name}"] = value
    for enc in ("visual_temporal", "audio_temporal"):
        for name, value in bilstm_from_flax(params.pop(enc)).items():
            sd[f"{enc}.{name}"] = value
    names = {"visual_fc/Dense_0": "visual_fc.dense",
             "audio_fc/Dense_0": "audio_fc.dense"}
    sd.update(_convert({"params": params}, lambda p: names.get(p, p)))
    return sd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="convert a JAX scorer checkpoint to a torch state_dict")
    ap.add_argument("--checkpoint", required=True, help="JAX checkpoint dir")
    ap.add_argument("--out", required=True, help="output .pt file")
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    from avsum_tpu.cli.main import _load_scorer
    from avsum_tpu.train.config import load_config

    model, params = _load_scorer(load_config(args.config, args.overrides),
                                 args.checkpoint)
    if model is None:
        raise SystemExit(f"no checkpoint in {args.checkpoint}")
    torch.save({"scorer": scorer_from_flax(params)}, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
