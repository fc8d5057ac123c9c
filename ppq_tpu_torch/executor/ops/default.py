"""Default op library: ONNX op semantics in PyTorch.

Port of ppq_tpu/executor/ops/default.py for the ops the ResNet-family main
path meets: after `format_graph` folds BatchNormalization into Conv
(ir/morph.py) these are Conv, Gemm, Relu, MaxPool, Add, GlobalAveragePool
and Flatten; BatchNormalization is kept for the unformatted graph; Reshape
and Transpose are what `stem_space_to_depth` (ir/morph.py) inserts before
the compiled executor runs the graph. The other ops of the JAX table are a
later slice (ROADMAP.md queue 1, item 3). Every
function has the signature

    f(op: Operation, values: List[Tensor | ndarray], ctx: ExecContext) -> Tensor

Values are torch tensors on the executor's device (activations and float
parameters) or host numpy arrays (shape and index operands). Convolutions and
matrix products stay library calls (`torch.nn.functional.conv*d`,
`torch.matmul`), as the JAX package leaves them to XLA.

Simulation fidelity: the executor runs every forward inside
`simulation_precision`, which sets `torch.backends.cudnn.allow_tf32 = False`
and `torch.backends.cuda.matmul.allow_tf32 = False`. cuDNN otherwise runs
fp32 convolutions in TF32, which would put TF32 rounding into every
quantization error the tool reports. The compiled executor's 'default' and
'bf16' modes turn TF32 on: the card's default-precision math, where the JAX
package takes the TPU's bf16 passes. The JAX package's
`accumulation_dtype` (an f32 result from bf16 operands) has no counterpart:
the compiled executor's integer codes are float32 already, so a float32
convolution or product accumulates and returns float32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

class simulation_precision:
    """The precision of convolutions and matmuls for the span of a forward.
    'highest' (the default) and 'int': cuDNN and cuBLAS in full float32, no
    TF32 ('int' keeps the ops it does not lower at fp32 fidelity; the
    compiled executor scopes 'default' around each contraction over integer
    codes, which TF32 holds exactly). 'default' and 'bf16': TF32 allowed. The
    previous flags are restored on exit."""

    def __init__(self, mode: str = 'highest'):
        if mode not in ('highest', 'int', 'default', 'bf16'):
            raise ValueError(f'unknown simulation precision {mode!r}')
        self._tf32 = mode in ('default', 'bf16')

    def __enter__(self):
        self._old = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self._tf32
        torch.backends.cuda.matmul.allow_tf32 = self._tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self._old


class ExecContext:
    """Per-forward context handed to every op fn (reference:
    op/torch/base.py TorchBackendContext)."""

    def __init__(self, graph=None, executing_order=None):
        self.graph = graph
        self.executing_order = executing_order
        self.detail: Dict[str, Any] = {}


def ASSERT_NUM_OF_INPUT(op, values, min_num: int, max_num: Optional[int] = None):
    max_num = max_num if max_num is not None else min_num
    if not (min_num <= len(values) <= max_num):
        raise ValueError(
            f'{op.type} op {op.name} expects {min_num}..{max_num} inputs, '
            f'got {len(values)}')


def attr(op, name, default=None):
    return op.attributes.get(name, default)


def _t(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A tensor operand, on the device of `like` when it comes from the
    host."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x),
                           device=like.device if like is not None else None)


def _present(values, idx) -> bool:
    """Optional input present and non-empty."""
    if len(values) <= idx or values[idx] is None:
        return False
    v = values[idx]
    return (v.numel() if isinstance(v, torch.Tensor) else np.size(v)) > 0


# ============================================================ conv family ===


def _conv_padding(op, spatial_rank: int, x_shape, w_shape, strides, dilations):
    auto_pad = attr(op, 'auto_pad', 'NOTSET')
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad in ('SAME_UPPER', 'SAME_LOWER'):
        pads = []
        for i in range(spatial_rank):
            in_dim = x_shape[2 + i]
            k = (w_shape[2 + i] - 1) * dilations[i] + 1
            out_dim = -(-in_dim // strides[i])
            total = max(0, (out_dim - 1) * strides[i] + k - in_dim)
            if auto_pad == 'SAME_UPPER':
                pads.append((total // 2, total - total // 2))
            else:
                pads.append((total - total // 2, total // 2))
        return pads
    if auto_pad == 'VALID':
        return [(0, 0)] * spatial_rank
    p = attr(op, 'pads', [0] * (2 * spatial_rank))
    return [(int(p[i]), int(p[i + spatial_rank])) for i in range(spatial_rank)]


def _pad_spec(pads):
    """(begin, end) pairs per spatial dim, first dim first -> F.pad order."""
    spec = []
    for begin, end in reversed(pads):
        spec += [begin, end]
    return spec


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def Conv_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    x = _t(values[0])
    w = _t(values[1], x)
    spatial = x.ndim - 2
    group = int(attr(op, 'group', 1))
    strides = [int(s) for s in attr(op, 'strides', [1] * spatial)]
    dilations = [int(d) for d in attr(op, 'dilations', [1] * spatial)]
    pads = _conv_padding(op, spatial, x.shape, w.shape, strides, dilations)
    if all(b == e for b, e in pads):
        padding = [b for b, _ in pads]
    else:
        x = F.pad(x, _pad_spec(pads))
        padding = 0
    bias = _t(values[2], x) if _present(values, 2) else None
    return _CONV[spatial](x, w, bias, stride=strides, padding=padding,
                          dilation=dilations, groups=group)


# ============================================================ pool family ===


def MaxPool_forward(op, values, ctx=None):
    x = _t(values[0])
    spatial = x.ndim - 2
    k = [int(v) for v in attr(op, 'kernel_shape')]
    strides = [int(s) for s in attr(op, 'strides', [1] * spatial)]
    p = attr(op, 'pads', [0] * 2 * spatial)
    pads = [(int(p[i]), int(p[i + spatial])) for i in range(spatial)]
    if int(attr(op, 'ceil_mode', 0)):
        for i in range(spatial):
            in_dim = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (in_dim - k[i]) % strides[i]
            if rem != 0:
                pads[i] = (pads[i][0], pads[i][1] + strides[i] - rem)
    if any(b or e for b, e in pads):
        x = F.pad(x, _pad_spec(pads), value=-float('inf'))
    return _MAX_POOL[spatial](x, k, strides)


def GlobalAveragePool_forward(op, values, ctx=None):
    x = _t(values[0])
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


# ========================================================== linear algebra ===


def Gemm_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    a = _t(values[0])
    b = _t(values[1], a)
    if int(attr(op, 'transA', 0)):
        a = a.T
    if int(attr(op, 'transB', 0)):
        b = b.T
    y = torch.matmul(a, b) * float(attr(op, 'alpha', 1.0))
    if len(values) > 2 and values[2] is not None:
        y = y + _t(values[2], a) * float(attr(op, 'beta', 1.0))
    return y


# ============================================================ elementwise ===


def Add_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 2)
    a = _t(values[0])
    return a + _t(values[1], a)


def Relu_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 1)
    return torch.relu(_t(values[0]))


# =============================================================== norms ===


def BatchNormalization_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 5)
    x = _t(values[0])
    gamma, beta, mean, var = (_t(v, x) for v in values[1:])
    eps = float(attr(op, 'epsilon', 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            * gamma.reshape(shape) + beta.reshape(shape))


# ======================================================== shape / movement ===


def Flatten_forward(op, values, ctx=None):
    x = _t(values[0])
    axis = int(attr(op, 'axis', 1))
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


def Reshape_forward(op, values, ctx=None):
    """The target shape is a host operand (an SOI input); 0 copies the
    input's dimension unless `allowzero`."""
    x = _t(values[0])
    shape = [int(v) for v in np.asarray(values[1]).reshape(-1)]
    if not int(attr(op, 'allowzero', 0)):
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def Transpose_forward(op, values, ctx=None):
    x = _t(values[0])
    perm = attr(op, 'perm', list(reversed(range(x.ndim))))
    return x.permute([int(p) for p in perm])


DEFAULT_BACKEND_TABLE = {
    'Conv': Conv_forward,
    'MaxPool': MaxPool_forward,
    'GlobalAveragePool': GlobalAveragePool_forward,
    'Gemm': Gemm_forward,
    'Add': Add_forward,
    'Relu': Relu_forward,
    'BatchNormalization': BatchNormalization_forward,
    'Flatten': Flatten_forward,
    'Reshape': Reshape_forward,
    'Transpose': Transpose_forward,
}
