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
  ``dense_{0,1}``; the staged encoder's ``stages`` (every leaf with a
  leading [n_stages] axis) -> ``stages.{s}.layers.{j}``;
- the MoE blocks' ``moe_ffn`` ``w1``/``b1``/``w2``/``b2`` keep their
  layout, its ``gate`` Dense -> Linear;
- the TCN's ``Conv_{i}`` kernel [K, Cin, Cout] -> Conv1d ``convs.{i}``
  weight [Cout, Cin, K], ``LayerNorm_{i}`` -> ``norms.{i}``;
- cross fusion's DenseGeneral ``q`` [E, H, D], ``kv`` [E, 2, H, D] and
  ``out`` [H, D, E] -> Linear(E, E), Linear(E, 2E), Linear(E, E);
- the ViT backbone's ``vit/patch_embed`` HWIO -> OIHW, ``cls`` and
  ``pos_embed`` as they are, its blocks as the attention encoder's,
  ``final_norm``, and the float32 ``project``.

``python -m avsum_torch.convert --params S.npz --visual V.npz --vggish
G.npz --out FILE.pt`` turns JAX weights, saved as numpy arrays under
their ``/``-joined Flax paths, into a dict of state_dicts for
``avsum_torch.cli summarize --weights FILE.pt`` (and ``preprocess``,
``serve``, ``export``): ``--params`` the scorer's params
(``visual_fc/Dense_0/kernel``, ...; every temporal encoder and fusion)
under "scorer", ``--visual`` the backbone's variables (``params/...`` and
``batch_stats/...``; the dual, ResNet50-only, ViT or tiny backbone) under
"visual", ``--vggish`` the audio encoder's params (VGGish or the large
encoder) under "vggish". At least one is needed. The ``.npz`` files are written where
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


def _prefixed(prefix: str, sd: Mapping[str, torch.Tensor]) -> Dict:
    return {f"{prefix}.{name}": value for name, value in sd.items()}


def _block_index(name: str, stem: str) -> int:
    return int(re.fullmatch(rf"{stem}(\d+)", name).group(1))


def _leaves(tree: Mapping) -> list:
    """The leaves of a nested dict, depth first."""
    return [leaf for value in tree.values()
            for leaf in (_leaves(value) if isinstance(value, Mapping)
                         else [value])]


def _map_leaves(tree: Mapping, fn) -> Dict:
    return {k: _map_leaves(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _convert(variables: Mapping, module_name) -> Dict[str, torch.Tensor]:
    """Generic leaf conversion; ``module_name`` maps a Flax module path
    ("a/b/c") to the port's dotted module path."""
    sd: Dict[str, torch.Tensor] = {}
    flat = _flatten(variables.get("params", {}))
    stats = _flatten(variables.get("batch_stats", {}))
    batch_norms = {path.rsplit("/", 1)[0] for path in stats}
    for path, value in flat.items():
        mod, leaf = path.rsplit("/", 1)
        name = module_name(mod)
        if leaf == "kernel" and value.ndim == 4:
            sd[f"{name}.weight"] = _tensor(value.transpose(3, 2, 0, 1))
        elif leaf == "kernel" and value.ndim == 2:
            sd[f"{name}.weight"] = _tensor(value.T)
        elif leaf == "scale":  # a BatchNorm's or a LayerNorm's
            sd[f"{name}.weight"] = _tensor(value)
            if mod in batch_norms:
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
    """VGGish or ``LargeAudioEncoder`` params -> state_dict. The port
    flattens VGGish's conv output in NHWC order, as Flax does, so
    ``fc1_1`` needs no row permutation."""
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


def _linear(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Dense {kernel [in, out], bias} -> Linear weight and bias."""
    return {"weight": _tensor(np.asarray(params["kernel"], np.float32).T),
            "bias": _tensor(params["bias"])}


def _pre_norm_attention(params: Mapping) -> Dict[str, torch.Tensor]:
    """A pre-norm block's {LayerNorm_0, MultiHeadSelfAttention_0,
    LayerNorm_1} -> norm_0, attention, norm_1."""
    sd = _prefixed("attention", attention_from_flax(
        params["MultiHeadSelfAttention_0"]))
    for flax_name, name in (("LayerNorm_0", "norm_0"),
                            ("LayerNorm_1", "norm_1")):
        sd[f"{name}.weight"] = _tensor(params[flax_name]["scale"])
        sd[f"{name}.bias"] = _tensor(params[flax_name]["bias"])
    return sd


def attention_block_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AttentionBlock params {LayerNorm_0, MultiHeadSelfAttention_0,
    LayerNorm_1, Dense_0, Dense_1} -> state_dict."""
    sd = _pre_norm_attention(params)
    for flax_name, name in (("Dense_0", "dense_0"), ("Dense_1", "dense_1")):
        sd.update(_prefixed(name, _linear(params[flax_name])))
    return sd


def attention_encoder_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AttentionEncoder params {block0, block1, ...} -> state_dict."""
    sd = {}
    for block, leaves in params.items():
        sd.update(_prefixed(f"blocks.{_block_index(block, 'block')}",
                            attention_block_from_flax(leaves)))
    return sd


def cross_attention_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MultiHeadCrossAttention params {q, kv, out} -> state_dict: kernels
    [E, H, D], [E, 2, H, D], [H, D, E] become Linear(E, E), Linear(E, 2E),
    Linear(E, E)."""
    sd = {}
    for name in ("q", "kv"):
        kernel = np.asarray(params[name]["kernel"], np.float32)
        sd[f"{name}.weight"] = _tensor(kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{name}.bias"] = _tensor(np.asarray(params[name]["bias"]).reshape(-1))
    out_k = np.asarray(params["out"]["kernel"], np.float32)
    sd["out.weight"] = _tensor(out_k.reshape(-1, out_k.shape[-1]).T)
    sd["out.bias"] = _tensor(params["out"]["bias"])
    return sd


def moe_ffn_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MoEFFN params {w1, b1, w2, b2, gate} -> state_dict: the expert
    tensors keep their layout, the ``gate`` Dense becomes a Linear."""
    sd = {leaf: _tensor(params[leaf]) for leaf in ("w1", "b1", "w2", "b2")}
    sd.update(_prefixed("gate", _linear(params["gate"])))
    return sd


def moe_encoder_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MoEEncoder params {block{i}: {LayerNorm_0, MultiHeadSelfAttention_0,
    LayerNorm_1, moe_ffn}} -> state_dict."""
    sd = {}
    for block, tree in params.items():
        prefix = f"blocks.{_block_index(block, 'block')}"
        sd.update(_prefixed(prefix, _pre_norm_attention(tree)))
        sd.update(_prefixed(f"{prefix}.moe_ffn",
                            moe_ffn_from_flax(tree["moe_ffn"])))
    return sd


def tcn_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """TemporalConvEncoder params {LayerNorm_i, Conv_i} -> state_dict; the
    1-D kernel [K, Cin, Cout] becomes Conv1d's [Cout, Cin, K]."""
    sd = {}
    for name, tree in params.items():
        kind, i = name.split("_")
        if kind == "Conv":
            kernel = np.asarray(tree["kernel"], np.float32)
            sd[f"convs.{i}.weight"] = _tensor(kernel.transpose(2, 1, 0))
            sd[f"convs.{i}.bias"] = _tensor(tree["bias"])
        else:
            sd[f"norms.{i}.weight"] = _tensor(tree["scale"])
            sd[f"norms.{i}.bias"] = _tensor(tree["bias"])
    return sd


def staged_encoder_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """PipelinedAttentionEncoder params {stages: {layer{j}: block}}, every
    leaf stacked on a leading [n_stages] axis -> state_dict of
    ``stages.{s}.layers.{j}``."""
    stacked = params["stages"]
    n_stages = len(_leaves(stacked)[0])
    sd = {}
    for s in range(n_stages):
        for layer, tree in stacked.items():
            one = _map_leaves(tree, lambda a: np.asarray(a)[s])
            sd.update(_prefixed(
                f"stages.{s}.layers.{_block_index(layer, 'layer')}",
                attention_block_from_flax(one)))
    return sd


def temporal_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """One temporal encoder's params -> state_dict, the encoder told
    apart by its module names."""
    if "fwd" in params:
        return bilstm_from_flax(params)
    if "stages" in params:
        return staged_encoder_from_flax(params)
    if "Conv_0" in params:
        return tcn_from_flax(params)
    if any("moe_ffn" in tree for tree in params.values()):
        return moe_encoder_from_flax(params)
    return attention_encoder_from_flax(params)


def scorer_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """AVScorer params (every temporal encoder, self or cross fusion) ->
    state_dict."""
    params = dict(params)
    sd: Dict[str, torch.Tensor] = {}
    if "cross_attention" in params:
        sd.update(_prefixed("cross_attention", attention_from_flax(
            params.pop("cross_attention"))))
    for name in ("v_attends_a", "a_attends_v"):
        if name in params:
            sd.update(_prefixed(name, cross_attention_from_flax(
                params.pop(name))))
    for enc in ("visual_temporal", "audio_temporal"):
        sd.update(_prefixed(enc, temporal_from_flax(params.pop(enc))))
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


def vit_backbone_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``ViTBackbone`` variables {"params": {"vit", "project"}} ->
    state_dict."""
    params = variables["params"]
    vit = dict(params["vit"])
    sd = {"vit.cls": _tensor(vit.pop("cls"))} if "cls" in vit else {}
    sd["vit.pos_embed"] = _tensor(vit.pop("pos_embed"))
    blocks = {k: vit.pop(k) for k in list(vit) if k.startswith("block")}
    sd.update(_prefixed("vit", attention_encoder_from_flax(blocks)))
    sd.update(_convert({"params": {"vit": vit, "project": params["project"]}},
                       lambda p: p.replace("/", ".")))
    return sd


TINY_BACKBONE_MODULES = {"Conv_0", "Conv_1", "Dense_0"}


def backbone_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The tiny, ViT, dual or ResNet50-only backbone's variables, told
    apart by their top-level module names -> state_dict."""
    modules = set(variables.get("params", {}))
    if modules <= TINY_BACKBONE_MODULES:
        return tiny_backbone_from_flax(variables)
    if "vit" in modules:
        return vit_backbone_from_flax(variables)
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
