"""A torchvision-layout ResNet-18, for runs without torchvision or its
downloaded weights (neither this package's tests nor the card's machine
have them): the modules and state-dict names of ``torchvision.models.
resnet18`` (``conv1``, ``bn1``, ``layer{1..4}.{0,1}.{conv1,bn1,conv2,bn2,
downsample.0,downsample.1}``, ``fc``), random weights from a seed and,
with ``random_stats``, randomized BatchNorm running statistics (fresh ones
are the trivial 0 / 1, which would not exercise their conversion). Its
``forward`` returns the eval-mode pooled features (B, 512), the fc left
out, as the CNN baseline's backbone gives them. The JAX package's test
builds the same model (``tests/test_baselines.py:227-285``)."""

from __future__ import annotations

import torch
from torch import nn


class _BasicBlock(nn.Module):

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + idt)


class TorchvisionResNet18(nn.Module):

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer1 = nn.Sequential(_BasicBlock(64, 64), _BasicBlock(64, 64))
        self.layer2 = nn.Sequential(_BasicBlock(64, 128, 2), _BasicBlock(128, 128))
        self.layer3 = nn.Sequential(_BasicBlock(128, 256, 2), _BasicBlock(256, 256))
        self.layer4 = nn.Sequential(_BasicBlock(256, 512, 2), _BasicBlock(512, 512))
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Linear(512, 1000)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W) -> pooled features (B, 512)."""
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return self.avgpool(x).flatten(1)


def torchvision_resnet18(seed: int = 0, random_stats: bool = True) -> TorchvisionResNet18:
    """The model on the CPU, in eval mode, its weights drawn under
    ``torch.manual_seed(seed)`` (torch's default init) and, with
    ``random_stats``, its BatchNorm running means from N(0, 0.05) and
    variances from U(0.5, 1.5). The caller's global RNG state is kept."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TorchvisionResNet18()
        if random_stats:
            with torch.no_grad():
                for mod in model.modules():
                    if isinstance(mod, nn.BatchNorm2d):
                        mod.running_mean.normal_(0, 0.05)
                        mod.running_var.uniform_(0.5, 1.5)
    return model.eval()
