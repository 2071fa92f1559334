"""The port's ViT backbone (``avsum_torch/vision/vit.py``) against
``avsum_tpu/vision/vit.py``: the mean-pool (s16 at its published widths,
at a 32-pixel image) and class-token layouts through ``convert
--visual``'s ``backbone_from_flax``; the torchvision ``vit_b_16``-layout
loader against ``avsum_tpu/vision/port_torch.py::vit_from_torch`` on a
seeded state_dict (both the ``mlp.0`` and ``mlp.linear_1`` namings), its
refusal of an unmapped key, and ``vit_backbone_from_torchvision``;
``make_backbone`` builds s16 and b16 at their widths. float32, JAX at
"highest" precision: rtol = atol = 1e-4 on features (12 blocks deep)."""

import jax
import numpy as np
import pytest
import torch

from avsum_tpu.vision.backbone import fast_init
from avsum_tpu.vision.port_torch import vit_from_torch
from avsum_tpu.vision.vit import ViT as JaxViT
from avsum_tpu.vision.vit import ViTBackbone as JaxViTBackbone
from avsum_torch.convert import backbone_from_flax
from avsum_torch.vision.backbone import make_backbone
from avsum_torch.vision.vit import (
    VIT_VARIANTS,
    ViT,
    ViTBackbone,
    vit_backbone_from_torchvision,
    vit_from_torchvision,
)
from avsum_torch.train.config import VisualFeatConfig

TOL = dict(rtol=1e-4, atol=1e-4)


def _frames(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def _moved(variables, seed):
    """Every leaf moved off its init (zero cls, LayerNorm 1 / 0)."""
    leaves, tree = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32)
        for p in leaves])


@pytest.mark.parametrize("variant,size", [("s16", 32), ("cls", 48)])
def test_backbone_matches_jax(variant, size):
    if variant == "s16":
        embed, depth, heads, cls = VIT_VARIANTS["s16"]
    else:
        embed, depth, heads, cls = 64, 2, 4, True
    kwargs = dict(out_dim=48, embed_dim=embed, depth=depth, num_heads=heads,
                  image_size=size, cls_token=cls)
    jm = JaxViTBackbone(**kwargs)
    frames = _frames(2, 40, 56, seed=1)
    variables = _moved(fast_init(jm, frames[:1], seed=2), 3)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jm.apply)(variables, frames))
    ours = ViTBackbone(**kwargs)
    ours.load_state_dict(backbone_from_flax(variables))
    with torch.inference_mode():
        got = ours(torch.from_numpy(frames))
    assert got.shape == (2, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _torchvision_state(embed=128, depth=2, patch=16, image=32, seed=0,
                       mlp=("mlp.0", "mlp.3")):
    """A seeded state_dict in torchvision's ``VisionTransformer`` layout
    (heads of 64 channels), as numpy arrays."""
    rng = np.random.default_rng(seed)
    n = (image // patch) ** 2 + 1

    def w(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"conv_proj.weight": w(embed, 3, patch, patch),
          "conv_proj.bias": w(embed), "class_token": w(1, 1, embed),
          "encoder.pos_embedding": w(1, n, embed),
          "encoder.ln.weight": 1 + w(embed), "encoder.ln.bias": w(embed),
          "heads.head.weight": w(10, embed), "heads.head.bias": w(10)}
    for i in range(depth):
        p = f"encoder.layers.encoder_layer_{i}."
        sd.update({
            p + "ln_1.weight": 1 + w(embed), p + "ln_1.bias": w(embed),
            p + "self_attention.in_proj_weight": w(3 * embed, embed),
            p + "self_attention.in_proj_bias": w(3 * embed),
            p + "self_attention.out_proj.weight": w(embed, embed),
            p + "self_attention.out_proj.bias": w(embed),
            p + "ln_2.weight": 1 + w(embed), p + "ln_2.bias": w(embed),
            p + mlp[0] + ".weight": w(4 * embed, embed),
            p + mlp[0] + ".bias": w(4 * embed),
            p + mlp[1] + ".weight": w(embed, 4 * embed),
            p + mlp[1] + ".bias": w(embed)})
    return sd


@pytest.mark.parametrize("mlp", [("mlp.0", "mlp.3"),
                                 ("mlp.linear_1", "mlp.linear_2")])
def test_torchvision_loader_matches_jax(mlp):
    sd = _torchvision_state(mlp=mlp)
    params, arch = vit_from_torch(sd)
    frames = _frames(2, 40, 40, seed=4)
    jm = JaxViT(cls_token=True, **arch)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(jm.apply)({"params": params}, frames))
    weights, ours_arch = vit_from_torchvision(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    assert ours_arch == arch == {"embed_dim": 128, "depth": 2, "num_heads": 2,
                                 "patch_size": 16, "image_size": 32}
    model = ViT(cls_token=True, **arch)
    model.load_state_dict(weights)
    with torch.inference_mode():
        got = model(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)

    backbone = vit_backbone_from_torchvision(sd, out_dim=24, seed=7)
    with torch.inference_mode():
        torch.testing.assert_close(backbone.vit(torch.from_numpy(frames)), got)
        assert backbone(torch.from_numpy(frames)).shape == (2, 24)
    again = vit_backbone_from_torchvision(sd, out_dim=24, seed=7)
    torch.testing.assert_close(again.project.weight, backbone.project.weight)


def test_torchvision_loader_refuses_unmapped_keys():
    sd = _torchvision_state()
    sd["encoder.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        vit_from_torch(dict(sd))
    with pytest.raises(KeyError, match="unmapped"):
        vit_from_torchvision(sd)


@pytest.mark.parametrize("variant", ["s16", "b16"])
def test_make_backbone_builds_the_variants(variant):
    cfg = VisualFeatConfig(backbone="vit", vit_variant=variant,
                           resnet_size=32, dtype="bfloat16")
    model = make_backbone(cfg, seed=0)
    embed, depth, heads, cls = VIT_VARIANTS[variant]
    assert len(model.vit.blocks) == depth
    assert model.vit.blocks[0].attention.num_heads == heads
    assert (model.vit.cls is not None) == cls
    assert model.vit.pos_embed.dtype == torch.bfloat16
    assert model.project.weight.dtype == torch.float32  # the float32 head
    with torch.inference_mode():
        out = model(torch.from_numpy(_frames(1, 24, 24, seed=5)))
    assert out.shape == (1, 4096) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="vit_variant"):
        make_backbone(VisualFeatConfig(backbone="vit", vit_variant="l16"))
