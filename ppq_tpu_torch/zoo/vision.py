"""In-repo vision model zoo: ResNet-18, MobileNetV2 (ONNX-semantic graphs
with deterministic random weights). Mirrors the architectures behind the
reference's benchmark tables (BASELINE.md) so the PTQ pipeline is exercised
on realistic topologies: residual adds (scale alignment), depthwise convs
(per-channel quant), Clip/ReLU6 (activation fusion), GAP + Gemm heads.
"""

from __future__ import annotations

import numpy as np

from ..ir import BaseGraph
from .builder import NetBuilder


def resnet18(num_classes: int = 1000, input_shape=(1, 3, 224, 224),
             seed: int = 0) -> BaseGraph:
    b = NetBuilder('resnet18', seed)
    x = b.input('input', input_shape)

    def block(x, cin, cout, stride):
        y = b.relu(b.bn(b.conv(x, cin, cout, 3, stride), cout))
        y = b.bn(b.conv(y, cout, cout, 3, 1), cout)
        if stride != 1 or cin != cout:
            x = b.bn(b.conv(x, cin, cout, 1, stride, pad=0), cout)
        return b.relu(b.add(y, x))

    y = b.relu(b.bn(b.conv(x, 3, 64, 7, 2, pad=3), 64))
    y = b.maxpool(y, 3, 2, pad=1)
    for cin, cout, stride in [(64, 64, 1), (64, 64, 1),
                              (64, 128, 2), (128, 128, 1),
                              (128, 256, 2), (256, 256, 1),
                              (256, 512, 2), (512, 512, 1)]:
        y = block(y, cin, cout, stride)
    y = b.flatten(b.gap(y))
    y = b.gemm(y, 512, num_classes)
    b.output(y)
    return b.g


def mobilenet_v2(num_classes: int = 1000, input_shape=(1, 3, 224, 224),
                 seed: int = 0, width: float = 1.0) -> BaseGraph:
    b = NetBuilder('mobilenetv2', seed)
    x = b.input('input', input_shape)

    def c(ch):
        return max(8, int(ch * width) // 8 * 8)

    def conv_bn_relu6(x, cin, cout, k, stride, group=1):
        y = b.conv(x, cin, cout, k, stride, group=group)
        return b.relu6(b.bn(y, cout))

    def inverted_residual(x, cin, cout, stride, expand):
        hidden = cin * expand
        y = x
        if expand != 1:
            y = conv_bn_relu6(y, cin, hidden, 1, 1)
        y = conv_bn_relu6(y, hidden, hidden, 3, stride, group=hidden)  # depthwise
        y = b.bn(b.conv(y, hidden, cout, 1, 1, pad=0), cout)           # linear
        if stride == 1 and cin == cout:
            y = b.add(x, y)
        return y

    y = conv_bn_relu6(x, 3, c(32), 3, 2)
    settings = [  # t, c, n, s  (MobileNetV2 paper table 2)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    cin = c(32)
    for t, ch, n, s in settings:
        for i in range(n):
            y = inverted_residual(y, cin, c(ch), s if i == 0 else 1, t)
            cin = c(ch)
    y = conv_bn_relu6(y, cin, c(1280), 1, 1)
    y = b.flatten(b.gap(y))
    y = b.gemm(y, c(1280), num_classes)
    b.output(y)
    return b.g


def tiny_cnn(num_classes: int = 10, input_shape=(1, 3, 32, 32),
             seed: int = 0) -> BaseGraph:
    """Small net for fast unit tests."""
    b = NetBuilder('tiny_cnn', seed)
    x = b.input('input', input_shape)
    y = b.relu(b.bn(b.conv(x, 3, 16, 3, 1), 16))
    skip = y
    y = b.relu(b.bn(b.conv(y, 16, 16, 3, 1), 16))
    y = b.add(y, skip)
    y = b.maxpool(y, 2, 2)
    y = b.flatten(b.gap(y))
    y = b.gemm(y, 16, num_classes)
    b.output(y)
    return b.g


def se_resnet_lite(num_classes: int = 100, input_shape=(1, 3, 64, 64),
                   seed: int = 0, reduction: int = 4) -> BaseGraph:
    """SE-ResNet (reference benchmark row BASELINE.md: SE-ResNet-50,
    /root/reference/README.md:185) at test scale: residual bottlenecks
    with squeeze-excitation heads. Exercises the GAP->Gemm->Sigmoid->Mul
    attention pattern through the quantizer (Mul with a per-batch gate is
    a genuinely different TQC topology than Conv/Add fusion paths)."""
    b = NetBuilder('se_resnet_lite', seed)
    x = b.input('input', input_shape)

    def se(y, c):
        s = b.flatten(b.gap(y))
        s = b.relu(b.gemm(s, c, max(4, c // reduction)))
        s = b.gemm(s, max(4, c // reduction), c)
        s = b.op('Sigmoid', [s])
        s = b.reshape(s, [-1, c, 1, 1])
        return b.op('Mul', [y, s])

    def block(y, cin, cout, stride):
        z = b.relu(b.bn(b.conv(y, cin, cout, 3, stride), cout))
        z = b.bn(b.conv(z, cout, cout, 3, 1), cout)
        z = se(z, cout)
        if stride != 1 or cin != cout:
            y = b.bn(b.conv(y, cin, cout, 1, stride, pad=0), cout)
        return b.relu(b.add(z, y))

    y = b.relu(b.bn(b.conv(x, 3, 16, 3, 1), 16))
    for cin, cout, stride in [(16, 16, 1), (16, 32, 2), (32, 64, 2)]:
        y = block(y, cin, cout, stride)
    y = b.flatten(b.gap(y))
    y = b.gemm(y, 64, num_classes)
    b.output(y)
    return b.g


def resnext_lite(num_classes: int = 100, input_shape=(1, 3, 64, 64),
                 seed: int = 0, cardinality: int = 8) -> BaseGraph:
    """ResNeXt (BASELINE.md row: ResNeXt-101, README.md:184) at test
    scale: bottlenecks whose 3x3 is a grouped conv with `cardinality`
    groups — the per-channel-quant-over-groups path (group > 1 but not
    depthwise) that neither resnet18 nor mobilenet_v2 covers."""
    b = NetBuilder('resnext_lite', seed)
    x = b.input('input', input_shape)

    def block(y, cin, width, cout, stride):
        z = b.relu(b.bn(b.conv(y, cin, width, 1, 1, pad=0), width))
        z = b.relu(b.bn(b.conv(z, width, width, 3, stride,
                               group=cardinality), width))
        z = b.bn(b.conv(z, width, cout, 1, 1, pad=0), cout)
        if stride != 1 or cin != cout:
            y = b.bn(b.conv(y, cin, cout, 1, stride, pad=0), cout)
        return b.relu(b.add(z, y))

    y = b.relu(b.bn(b.conv(x, 3, 16, 3, 1), 16))
    for cin, width, cout, stride in [(16, 16, 32, 1), (32, 32, 64, 2),
                                     (64, 64, 128, 2)]:
        y = block(y, cin, width, cout, stride)
    y = b.flatten(b.gap(y))
    y = b.gemm(y, 128, num_classes)
    b.output(y)
    return b.g


def shufflenet_v2_lite(num_classes: int = 100, input_shape=(1, 3, 64, 64),
                       seed: int = 0) -> BaseGraph:
    """ShuffleNetV2 (BASELINE.md row, README.md:186) at test scale:
    Split / depthwise / Concat units with the channel-shuffle
    Reshape-Transpose-Reshape — the memory-movement op chain that the
    scheduler must keep with its quant region and the ONNX exporters
    must round-trip (it quantizes nothing by itself but carries TQCs)."""
    b = NetBuilder('shufflenet_v2_lite', seed)
    x = b.input('input', input_shape)

    def shuffle(y, c, hw):
        y = b.reshape(y, [-1, 2, c // 2, hw, hw])
        y = b.transpose(y, [0, 2, 1, 3, 4])
        return b.reshape(y, [-1, c, hw, hw])

    def unit(y, c, hw):
        lo, hi = b.op('Split', [y], n_out=2, axis=1)
        z = b.relu(b.bn(b.conv(hi, c // 2, c // 2, 1, 1, pad=0), c // 2))
        z = b.bn(b.conv(z, c // 2, c // 2, 3, 1, group=c // 2), c // 2)
        z = b.relu(b.bn(b.conv(z, c // 2, c // 2, 1, 1, pad=0), c // 2))
        y = b.concat([lo, z], axis=1)
        return shuffle(y, c, hw)

    def down_unit(y, cin, cout, hw):
        half = cout // 2
        # right branch: 1x1 -> dw stride2 -> 1x1
        z = b.relu(b.bn(b.conv(y, cin, half, 1, 1, pad=0), half))
        z = b.bn(b.conv(z, half, half, 3, 2, group=half), half)
        z = b.relu(b.bn(b.conv(z, half, half, 1, 1, pad=0), half))
        # left branch: dw stride2 -> 1x1
        w = b.bn(b.conv(y, cin, cin, 3, 2, group=cin), cin)
        w = b.relu(b.bn(b.conv(w, cin, half, 1, 1, pad=0), half))
        y = b.concat([w, z], axis=1)
        return shuffle(y, cout, hw)

    hw = input_shape[-1] // 2
    y = b.relu(b.bn(b.conv(x, 3, 16, 3, 2), 16))
    y = down_unit(y, 16, 32, hw // 2)
    y = unit(y, 32, hw // 2)
    y = down_unit(y, 32, 64, hw // 4)
    y = unit(y, 64, hw // 4)
    y = b.relu(b.bn(b.conv(y, 64, 128, 1, 1, pad=0), 128))
    y = b.flatten(b.gap(y))
    y = b.gemm(y, 128, num_classes)
    b.output(y)
    return b.g
