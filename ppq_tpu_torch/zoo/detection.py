"""Detection-family models (BASELINE config: "YOLOv6 detection: scheduler
quant/non-quant region dispatch, QuantFusion, LSQ block-wise finetune").

yolo_lite reproduces the structural patterns that make YOLO graphs the
canonical scheduler workload: a conv backbone, Resize-based feature-pyramid
upsampling, Concat merges, a decode head with Shape/Gather/Concat SOI
chains, Sigmoid activations, and multi-scale outputs.
"""

from __future__ import annotations

import numpy as np

from ..ir import BaseGraph
from .builder import NetBuilder


def yolo_lite(num_classes: int = 20, in_size: int = 64, batch: int = 1,
              seed: int = 0) -> BaseGraph:
    b = NetBuilder('yolo_lite', seed)
    x = b.input('image', [batch, 3, in_size, in_size])

    def cbl(v, cin, cout, k=3, s=1):
        """conv + bn + leaky-relu block."""
        v = b.bn(b.conv(v, cin, cout, k, s), cout)
        return b.op('LeakyRelu', [v], alpha=0.1)

    # backbone: 3 stages
    c1 = cbl(x, 3, 16, 3, 2)          # /2
    c2 = cbl(c1, 16, 32, 3, 2)        # /4
    c2 = cbl(c2, 32, 32)
    c3 = cbl(c2, 32, 64, 3, 2)        # /8
    c3 = cbl(c3, 64, 64)

    # neck: upsample c3, concat with c2 (FPN pattern)
    up = b.op('Resize', [
        c3,
        b.param(np.zeros(0, np.float32)),            # roi (empty)
        b.param(np.array([1, 1, 2, 2], np.float32)), # scales
    ], mode='nearest', coordinate_transformation_mode='asymmetric')
    merged = b.concat([up, c2], axis=1)               # (B, 96, /4)
    n1 = cbl(merged, 96, 48, 1)

    # heads: per-scale prediction convs (box4 + obj1 + classes)
    pred_ch = 5 + num_classes
    p_small = b.conv(n1, 48, pred_ch, 1, pad=0)       # /4 scale
    p_large = b.conv(c3, 64, pred_ch, 1, pad=0)       # /8 scale

    # decode head with SOI shape chain: flatten predictions to (B, N, C)
    def decode(p):
        shp = b.op('Shape', [p])
        bsz = b.op('Gather', [shp, b.iparam(np.asarray(0))], axis=0)
        bsz = b.op('Unsqueeze', [bsz, b.iparam(np.asarray([0]))])
        tgt = b.concat([bsz, b.iparam(np.asarray([pred_ch])),
                        b.iparam(np.asarray([-1]))], axis=0)
        flat = b.op('Reshape', [p, tgt])              # (B, C, N)
        flat = b.transpose(flat, [0, 2, 1])           # (B, N, C)
        return b.op('Sigmoid', [flat])

    out = b.concat([decode(p_small), decode(p_large)], axis=1)
    b.output(out)
    return b.g
