"""ResNet-50's feature trunk (He et al., 2016), a frozen copy of the
port's plain module: torchvision's layout and names, BatchNorm eps 1e-5
with running statistics, input NCHW, output [B, 2048] float32 after the
global average pool."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * planes, eps=1e-5)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, 4 * planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(4 * planes, eps=1e-5),
            )
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """[B, 3, 224, 224] normalized RGB -> [B, 2048] pooled features."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for stage, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(Bottleneck(inplanes, planes, stride,
                                         downsample=(block == 0)))
                inplanes = 4 * planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3)).float()
