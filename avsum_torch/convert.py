"""Weight bridge: Flax param trees (nested dicts of arrays) -> the port's
state_dicts. The inverse of ``avsum_tpu/vision/port_torch.py`` and
``avsum_tpu/audio/port_vggish.py``.

- conv ``kernel`` HWIO -> ``weight`` OIHW; Dense ``kernel`` [in, out] ->
  Linear ``weight`` [out, in];
- BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  -> ``weight``/``bias``/``running_mean``/``running_var``;
- the attention's DenseGeneral ``qkv`` kernel [E, 3, H, D] and ``out``
  kernel [H, D, E] -> Linear(E, 3E) and Linear(E, E);
- LSTM ``wi`` [F, 4H], ``wh`` [H, 4H], ``b`` [4H] keep their layout;
- the attention encoder's ``block{i}/LayerNorm_{0,1}`` ``scale``/``bias``
  -> ``blocks.{i}.norm_{0,1}`` ``weight``/``bias``, its
  ``MultiHeadSelfAttention_0`` -> ``attention`` and ``Dense_{0,1}`` ->
  ``dense_{0,1}``.

``python -m avsum_torch.convert --params S.npz --visual V.npz --vggish
G.npz --out FILE.pt`` turns JAX weights, saved as numpy arrays under
their ``/``-joined Flax paths, into a dict of state_dicts for
``avsum_torch.cli summarize --weights FILE.pt`` (and ``preprocess``,
``serve``, ``export``): ``--params`` the scorer's params
(``visual_fc/Dense_0/kernel``, ...) under "scorer", ``--visual`` the
backbone's variables (``params/...`` and ``batch_stats/...``; the dual or
the tiny backbone) under "visual", ``--vggish`` VGGish's params under
"vggish". At least one is needed. The ``.npz`` files are written where
JAX is installed (README.md gives the lines); this module imports no JAX.
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


def attention_block_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AttentionBlock params {LayerNorm_0, MultiHeadSelfAttention_0,
    LayerNorm_1, Dense_0, Dense_1} -> state_dict."""
    sd = {f"attention.{name}": value for name, value in
          attention_from_flax(params["MultiHeadSelfAttention_0"]).items()}
    for flax_name, name in (("LayerNorm_0", "norm_0"),
                            ("LayerNorm_1", "norm_1")):
        sd[f"{name}.weight"] = _tensor(params[flax_name]["scale"])
        sd[f"{name}.bias"] = _tensor(params[flax_name]["bias"])
    for flax_name, name in (("Dense_0", "dense_0"), ("Dense_1", "dense_1")):
        sd[f"{name}.weight"] = _tensor(np.asarray(params[flax_name]["kernel"]).T)
        sd[f"{name}.bias"] = _tensor(params[flax_name]["bias"])
    return sd


def attention_encoder_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AttentionEncoder params {block0, block1, ...} -> state_dict."""
    sd = {}
    for block, leaves in params.items():
        i = int(re.fullmatch(r"block(\d+)", block).group(1))
        for name, value in attention_block_from_flax(leaves).items():
            sd[f"blocks.{i}.{name}"] = value
    return sd


def scorer_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AVScorer params (bilstm or attention encoder, self fusion) ->
    state_dict."""
    params = dict(params)
    sd: Dict[str, torch.Tensor] = {}
    for name, value in attention_from_flax(params.pop("cross_attention")).items():
        sd[f"cross_attention.{name}"] = value
    for enc in ("visual_temporal", "audio_temporal"):
        tree = params.pop(enc)
        convert = (bilstm_from_flax if "fwd" in tree
                   else attention_encoder_from_flax)
        for name, value in convert(tree).items():
            sd[f"{enc}.{name}"] = value
    names = {"visual_fc/Dense_0": "visual_fc.dense",
             "audio_fc/Dense_0": "audio_fc.dense"}
    sd.update(_convert({"params": params}, lambda p: names.get(p, p)))
    return sd


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    """``{"a/b/c": array}`` -> ``{"a": {"b": {"c": array}}}``, the inverse
    of ``flax.traverse_util.flatten_dict(tree, sep="/")``."""
    tree: Dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


TINY_BACKBONE_MODULES = {"Conv_0", "Conv_1", "Dense_0"}


def backbone_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The tiny or the dual backbone's variables, told apart by their
    top-level module names -> state_dict."""
    if set(variables.get("params", {})) <= TINY_BACKBONE_MODULES:
        return tiny_backbone_from_flax(variables)
    return dual_backbone_from_flax(variables)


def _load_npz(path: str) -> Dict:
    with np.load(path) as npz:
        return unflatten({name: npz[name] for name in npz.files})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="convert JAX weights (.npz of /-joined Flax paths) to "
                    "a torch file of state_dicts")
    ap.add_argument("--params", default=None,
                    help="the scorer's params")
    ap.add_argument("--visual", default=None,
                    help="the visual backbone's variables (params/... and "
                         "batch_stats/...)")
    ap.add_argument("--vggish", default=None, help="VGGish's params")
    ap.add_argument("--out", required=True, help="output .pt file")
    args = ap.parse_args(argv)
    parts = {}
    if args.params:
        parts["scorer"] = scorer_from_flax(_load_npz(args.params))
    if args.visual:
        parts["visual"] = backbone_from_flax(_load_npz(args.visual))
    if args.vggish:
        parts["vggish"] = vggish_from_flax(_load_npz(args.vggish))
    if not parts:
        ap.error("give at least one of --params, --visual, --vggish")
    torch.save(parts, args.out)
    print(f"wrote {args.out} ({', '.join(parts)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
