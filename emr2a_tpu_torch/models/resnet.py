"""ResNet-18 for the CNN baseline.

Port of ``emr2a_tpu/models/resnet.py``: the reference baseline's
torchvision resnet18 backbone without its fc, globally average-pooled
(``BasicBlock``, ``ResNet18``), the slice-mean ``ImageOnlyModel`` and the
clinical-fusion ``MultimodalModel``. Inputs are JAX's: images (B, K, H, W,
3) and clinical rows (B, 3); the convolutions run in NCHW on a permuted
view (so the memory stays channels-last). The stem (7×7/2, padding 3), the
3×3/2 max-pool (padding 1, -inf pad), the strides and the 1×1 downsample
follow ``emr2a_tpu/models/resnet.py:24-75``. Module names follow the flax
tree (``stem_conv``, ``stage{s}_block{b}.conv1``, ``downsample_bn``, ...),
so ``models/convert.resnet_from_jax`` and ``convert_torch_resnet18`` map
onto them.

``BatchNorm`` follows flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5), not
``nn.BatchNorm2d``: in training it normalizes with the biased batch
variance ``E[x²] - E[x]²`` (clipped at 0, flax's fast variance, gradients
through both statistics) and updates ``running_var`` with that same biased
variance (``ra = 0.9 ra + 0.1 var``), where torch would use the unbiased
one; in eval it uses the running statistics. Train or eval is the module's
``training`` flag (JAX's ``train=`` argument).

Random init (``init_resnet``) draws every conv and linear weight from
N(0, 1/fan_in) and zeroes the biases, on the CPU from a seeded
``torch.Generator`` in parameter order, so a seed gives the same weights on
every device. It differs from flax's init (truncated LeCun normal from a
``PRNGKey``): the two packages' random models differ, and tests carry JAX's
variables across instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW's channel axis (see the module
    docstring). Parameters ``weight`` (flax's ``scale``) and ``bias``;
    buffers ``running_mean`` / ``running_var`` (its ``batch_stats``)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))   # flax: at least f32
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        return torch.addcmul(shift[:, None, None], xf, scale[:, None, None]).to(x.dtype)


class BasicBlock(nn.Module):

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        kw = dict(bias=False)
        self.conv1 = nn.Conv2d(in_features, features, 3, strides, 1, **kw)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, **kw)
        self.bn2 = BatchNorm(features)
        if strides != 1 or in_features != features:
            self.downsample_conv = nn.Conv2d(in_features, features, 1, strides, 0, **kw)
            self.downsample_bn = BatchNorm(features)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet18(nn.Module):
    """Backbone only: (B, H, W, 3) -> (B, 512) pooled features."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = BatchNorm(64)
        features, in_features = 64, 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                self.add_module(f"stage{stage}_block{block}",
                                BasicBlock(in_features, features, strides))
                in_features = features
            features *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)               # NHWC -> NCHW view
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                x = getattr(self, f"stage{stage}_block{block}")(x)
        return x.mean(dim=(2, 3))               # global average pool -> (B, 512)


def init_resnet(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place (see the module docstring)."""
    with torch.no_grad():
        for name, param in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0])
            if isinstance(owner, BatchNorm):
                continue                        # scale 1, bias 0 as built
            if name.endswith("bias"):
                param.zero_()
                continue
            fan_in = param[0].numel()
            draw = torch.randn(param.shape, generator=generator) * fan_in ** -0.5
            param.copy_(draw.to(param.dtype))
    return module


def _images_to_features(backbone: ResNet18, images: torch.Tensor) -> torch.Tensor:
    B, K, H, W, C = images.shape
    feats = backbone(images.reshape(B * K, H, W, C))
    return feats.reshape(B, K, -1).mean(dim=1)


class ImageOnlyModel(nn.Module):
    """ResNet18 over K slices, slice-mean pooled, linear head
    (train_cnn_baseline.py:132-149 semantics)."""

    def __init__(self, num_classes: int = 4, seed: int = 0):
        super().__init__()
        self.backbone = ResNet18()
        self.fc = nn.Linear(512, num_classes)
        init_resnet(self, torch.Generator().manual_seed(seed))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.fc(_images_to_features(self.backbone, images))


class MultimodalModel(nn.Module):
    """+ clinical MLP and fusion head
    (train_cnn_baseline.py:152-176 semantics)."""

    def __init__(self, num_classes: int = 4, clinical_dim: int = 3, seed: int = 0):
        super().__init__()
        self.backbone = ResNet18()
        self.image_fc = nn.Linear(512, 128)
        self.clinical_fc = nn.Linear(clinical_dim, 32)
        self.fusion_fc = nn.Linear(128 + 32, num_classes)
        init_resnet(self, torch.Generator().manual_seed(seed))

    def forward(self, images: torch.Tensor,
                clinical: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = _images_to_features(self.backbone, images)
        image_feat = F.relu(self.image_fc(feats))
        clinical_feat = F.relu(self.clinical_fc(clinical.to(feats.dtype)))
        return self.fusion_fc(torch.cat([image_feat, clinical_feat], dim=1))
