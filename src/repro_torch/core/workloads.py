"""CNN workloads for the DLA case study (§VI-D): AlexNet and ResNet-34.

Copy of `repro.core.workloads` for the PyTorch port, which imports nothing of
the JAX package: every constant and expression as there, in the same
order, so each derived number matches to the last digit.

Each conv layer is described by its GEMM-equivalent dimensions used by the
DLA cycle model: output spatial (H_out, W_out), output channels K,
input channels C, and filter taps R×S.  FC layers are 1×1 convs on a 1×1
feature map.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    h_out: int
    w_out: int
    k: int        # output channels
    c: int        # input channels (per group)
    r: int        # filter height
    s: int        # filter width

    @property
    def macs(self) -> int:
        return self.h_out * self.w_out * self.k * self.c * self.r * self.s

    @property
    def weights(self) -> int:
        return self.k * self.c * self.r * self.s


ALEXNET = (
    ConvLayer("conv1", 55, 55, 96, 3, 11, 11),
    ConvLayer("conv2", 27, 27, 256, 48, 5, 5),
    ConvLayer("conv3", 13, 13, 384, 256, 3, 3),
    ConvLayer("conv4", 13, 13, 384, 192, 3, 3),
    ConvLayer("conv5", 13, 13, 256, 192, 3, 3),
    ConvLayer("fc6", 1, 1, 4096, 256, 6, 6),
    ConvLayer("fc7", 1, 1, 4096, 4096, 1, 1),
    ConvLayer("fc8", 1, 1, 1000, 4096, 1, 1),
)


def _resnet_stage(name, n, h, k, c_first):
    layers = []
    for i in range(n):
        c_in = c_first if i == 0 else k
        layers.append(ConvLayer(f"{name}_{i}a", h, h, k, c_in, 3, 3))
        layers.append(ConvLayer(f"{name}_{i}b", h, h, k, k, 3, 3))
    return layers


RESNET34 = tuple(
    [ConvLayer("conv1", 112, 112, 64, 3, 7, 7)]
    + _resnet_stage("layer1", 3, 56, 64, 64)
    + [ConvLayer("layer2_ds", 28, 28, 128, 64, 1, 1)]
    + _resnet_stage("layer2", 4, 28, 128, 64)
    + [ConvLayer("layer3_ds", 14, 14, 256, 128, 1, 1)]
    + _resnet_stage("layer3", 6, 14, 256, 128)
    + [ConvLayer("layer4_ds", 7, 7, 512, 256, 1, 1)]
    + _resnet_stage("layer4", 3, 7, 512, 256)
    + [ConvLayer("fc", 1, 1, 1000, 512, 1, 1)]
)

MODELS = {"alexnet": ALEXNET, "resnet34": RESNET34}
