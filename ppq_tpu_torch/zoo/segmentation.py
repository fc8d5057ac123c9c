"""Segmentation / super-resolution family models
(QuantZoo protocol families: Cityscapes segmentation, DIV2K super-res —
BASELINE.md deeplab/srcnn rows). Exercise dilated convolutions, bilinear
Resize, ConvTranspose, and DepthToSpace in the quantization pipeline.
"""

from __future__ import annotations

import numpy as np

from ..ir import BaseGraph
from .builder import NetBuilder


def deeplab_lite(num_classes: int = 8, in_size: int = 32, batch: int = 1,
                 seed: int = 0) -> BaseGraph:
    """DeepLab-pattern: strided backbone → ASPP-style parallel dilated convs
    → concat → classifier → bilinear upsample to input size."""
    b = NetBuilder('deeplab_lite', seed)
    x = b.input('image', [batch, 3, in_size, in_size])

    y = b.relu(b.bn(b.conv(x, 3, 16, 3, 2), 16))         # /2
    y = b.relu(b.bn(b.conv(y, 16, 32, 3, 2), 32))        # /4

    # ASPP: parallel branches with different dilation rates
    def dilated(v, rate):
        w = b.param(b.rng.randn(16, 32, 3, 3) * np.sqrt(2.0 / (32 * 9)))
        return b.op('Conv', [v, w], kernel_shape=[3, 3], strides=[1, 1],
                    pads=[rate] * 4, dilations=[rate, rate], group=1)

    branches = [b.relu(dilated(y, r)) for r in (1, 2, 4)]
    w1 = b.param(b.rng.randn(16, 32, 1, 1) * 0.3)
    branches.append(b.relu(b.op('Conv', [y, w1], kernel_shape=[1, 1],
                                strides=[1, 1], pads=[0, 0, 0, 0],
                                dilations=[1, 1], group=1)))
    y = b.concat(branches, axis=1)                       # (B, 64, /4)
    y = b.relu(b.conv(y, 64, 32, 1, pad=0))
    y = b.conv(y, 32, num_classes, 1, pad=0)

    # bilinear upsample back to input resolution
    up = b.op('Resize', [
        y, b.param(np.zeros(0, np.float32)),
        b.param(np.array([1, 1, 4, 4], np.float32))],
        mode='linear', coordinate_transformation_mode='half_pixel')
    b.output(up)
    return b.g


def srcnn(scale: int = 2, in_size: int = 16, batch: int = 1,
          seed: int = 0) -> BaseGraph:
    """SRCNN-pattern super-resolution: feature extraction → mapping →
    ESPCN-style DepthToSpace upsample."""
    b = NetBuilder('srcnn', seed)
    x = b.input('lr_image', [batch, 1, in_size, in_size])
    y = b.relu(b.conv(x, 1, 16, 5, pad=2))
    y = b.relu(b.conv(y, 16, 16, 3))
    y = b.conv(y, 16, scale * scale, 3)
    hr = b.op('DepthToSpace', [y], blocksize=scale, mode='CRD')
    b.output(hr)
    return b.g


def unet_lite(in_size: int = 32, batch: int = 1, seed: int = 0) -> BaseGraph:
    """U-Net-pattern encoder/decoder with ConvTranspose upsampling and skip
    concat — exercises the transposed-conv quant path."""
    b = NetBuilder('unet_lite', seed)
    x = b.input('image', [batch, 3, in_size, in_size])
    e1 = b.relu(b.conv(x, 3, 8, 3))
    e2 = b.relu(b.conv(b.maxpool(e1, 2, 2), 8, 16, 3))

    w_up = b.param(b.rng.randn(16, 8, 2, 2) * 0.2)   # (Cin, Cout, k, k)
    up = b.op('ConvTranspose', [e2, w_up], kernel_shape=[2, 2],
              strides=[2, 2], pads=[0, 0, 0, 0], dilations=[1, 1], group=1)
    d1 = b.concat([up, e1], axis=1)
    d1 = b.relu(b.conv(d1, 16, 8, 3))
    out = b.conv(d1, 8, 1, 1, pad=0)
    b.output(out)
    return b.g
