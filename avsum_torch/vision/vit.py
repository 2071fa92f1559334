"""Vision Transformer backbone (``avsum_tpu/vision/vit.py``), the
``visual.backbone: vit`` option.

:class:`ViT`: frames normalized and resized to ``image_size`` (as every
backbone of the port), a ``patch_size`` convolution with "SAME" padding
as the patch embedding, learned position embeddings, the port's
pre-norm :class:`~avsum_torch.models.temporal.AttentionBlock` (exact GELU,
materialized attention: the flash kernel stays off, as the JAX ViT's
blocks take no kernel), a final LayerNorm, then the mean over the tokens
(s16) or the class token (b16, torchvision's ``vit_b_16`` layout). The
transformer runs in the backbone dtype, ``cls`` and ``pos_embed``
included; :class:`ViTBackbone`'s ``project`` to ``feature_dim`` stays
float32, as in JAX.

:func:`vit_from_torchvision` maps a torchvision ``vit_b_16``-layout
state_dict onto the port's :class:`ViT` with the key map of
``avsum_tpu/vision/port_torch.py::vit_from_torch`` and refuses a key it
does not map; :func:`vit_backbone_from_torchvision` adds a seeded
random ``project``, as ``avsum_tpu/vision/vit.py::vit_backbone_variables``
does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from avsum_torch.init import fast_init_
from avsum_torch.models.temporal import LAYER_NORM_EPS, AttentionBlock
from avsum_torch.vision.backbone import _same_pad, preprocess_frames

# named variants: (embed_dim, depth, num_heads, cls_token)
VIT_VARIANTS = {
    "s16": (384, 12, 6, False),  # mean pool
    "b16": (768, 12, 12, True),  # torchvision vit_b_16 layout
}


class ViT(nn.Module):
    """[B, H, W, 3] RGB frames -> [B, embed_dim] float32."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 cls_token: bool = False, dtype=torch.float32):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.dtype = dtype
        grid = -(-image_size // patch_size)
        n_tokens = grid * grid + int(cls_token)
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size,
                                     stride=patch_size)
        self.cls = (nn.Parameter(torch.zeros(1, 1, embed_dim))
                    if cls_token else None)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim))
        self.blocks = nn.ModuleList(
            AttentionBlock(embed_dim, num_heads, 0.0, dtype, use_kernel=False)
            for _ in range(depth))
        self.final_norm = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)
        self.to(dtype)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = preprocess_frames(frames, self.image_size, self.dtype)
        x = self.patch_embed(_same_pad(x, self.patch_size, self.patch_size))
        x = x.flatten(2).transpose(1, 2)  # [B, gh * gw, E], row-major grid
        if self.cls is not None:
            x = torch.cat([self.cls.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x)
        x = self.final_norm(x)
        pooled = x[:, 0] if self.cls is not None else x.mean(dim=1)
        return pooled.float()


class ViTBackbone(nn.Module):
    """:class:`ViT` features projected to ``out_dim`` by a float32
    Linear, so the scorer and the feature cache do not depend on the
    backbone."""

    def __init__(self, out_dim: int = 4096, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, image_size: int = 224,
                 patch_size: int = 16, cls_token: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.vit = ViT(image_size, patch_size, embed_dim, depth, num_heads,
                       cls_token, dtype)
        self.project = nn.Linear(embed_dim, out_dim)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.project(self.vit(frames))


def vit_from_torchvision(state_dict: Mapping[str, torch.Tensor]
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """torchvision ``vit_b_16``-layout state_dict -> (the port's
    :class:`ViT` state_dict, arch), arch being the ``ViT`` arguments
    ``embed_dim``, ``depth``, ``num_heads``, ``patch_size`` and
    ``image_size`` (with ``cls_token=True``).

    conv_proj -> patch_embed, class_token -> cls, encoder.pos_embedding ->
    pos_embed, encoder.layers.encoder_layer_i.{ln_1, self_attention.in_proj,
    self_attention.out_proj, ln_2, mlp.0 | mlp.linear_1, mlp.3 |
    mlp.linear_2} -> blocks.i.{norm_0, attention.qkv, attention.out,
    norm_1, dense_0, dense_1} (torch's packed q;k;v rows are the port's
    qkv layout already), encoder.ln -> final_norm; heads.* dropped. Heads
    = embed_dim / 64, as in every torchvision ViT. A key left over raises
    KeyError."""
    sd = {k: torch.as_tensor(v).detach().float().cpu()
          for k, v in state_dict.items() if not k.startswith("heads.")}
    embed = int(sd["class_token"].shape[-1])
    n_pos = int(sd["encoder.pos_embedding"].shape[1])
    patch = int(sd["conv_proj.weight"].shape[-1])
    grid = int(round((n_pos - 1) ** 0.5))
    depth = 1 + max(int(k.split("encoder_layer_")[1].split(".")[0])
                    for k in sd if "encoder_layer_" in k)
    out = {
        "patch_embed.weight": sd.pop("conv_proj.weight"),
        "patch_embed.bias": sd.pop("conv_proj.bias"),
        "cls": sd.pop("class_token"),
        "pos_embed": sd.pop("encoder.pos_embedding"),
        "final_norm.weight": sd.pop("encoder.ln.weight"),
        "final_norm.bias": sd.pop("encoder.ln.bias"),
    }
    for i in range(depth):
        src, dst = f"encoder.layers.encoder_layer_{i}.", f"blocks.{i}."
        names = {"ln_1": "norm_0", "self_attention.in_proj": "attention.qkv",
                 "self_attention.out_proj": "attention.out", "ln_2": "norm_1"}
        for mlp, name in ((("mlp.0", "mlp.linear_1"), "dense_0"),
                          (("mlp.3", "mlp.linear_2"), "dense_1")):
            names[next(c for c in mlp if f"{src}{c}.weight" in sd)] = name
        for theirs, ours in names.items():
            for leaf in ("weight", "bias"):
                key = (f"{src}{theirs}_{leaf}" if theirs.endswith("in_proj")
                       else f"{src}{theirs}.{leaf}")
                out[f"{dst}{ours}.{leaf}"] = sd.pop(key)
    leftovers = [k for k in sd if "dropout" not in k]
    if leftovers:
        raise KeyError(f"unmapped torchvision ViT keys: {leftovers[:5]}")
    arch = {"embed_dim": embed, "depth": depth, "num_heads": embed // 64,
            "patch_size": patch, "image_size": grid * patch}
    return out, arch


def vit_backbone_from_torchvision(state_dict: Mapping[str, torch.Tensor],
                                  out_dim: int = 4096, seed: int = 0,
                                  dtype=torch.float32) -> ViTBackbone:
    """A torchvision ``vit_b_16``-layout checkpoint -> a
    :class:`ViTBackbone` (class-token layout): the transformer from the
    checkpoint, ``project`` to ``out_dim`` a seeded random linear map."""
    weights, arch = vit_from_torchvision(state_dict)
    model = ViTBackbone(out_dim, arch["embed_dim"], arch["depth"],
                        arch["num_heads"], arch["image_size"],
                        arch["patch_size"], cls_token=True, dtype=dtype)
    fast_init_(model.project, seed)
    model.vit.load_state_dict(weights)
    return model
