"""Default op library: ONNX op semantics in PyTorch.

Port of ppq_tpu/executor/ops/default.py for the ops the ResNet-family main
path meets: after `format_graph` folds BatchNormalization into Conv
(ir/morph.py) these are Conv, Gemm, Relu, MaxPool, Add, GlobalAveragePool
and Flatten; BatchNormalization is kept for the unformatted graph; Reshape
and Transpose are what `stem_space_to_depth` (ir/morph.py) inserts before
the compiled executor runs the graph. QuantizeLinear, DequantizeLinear,
QuantizeFloating, DequantizeFloating and PPQDeviceSwitch are what an
exported QDQ graph (frontends/onnxruntime.py) and a switched graph
(ir/deploy.py) add. The other ops of the JAX table are a later slice
(ROADMAP.md queue 1, item 3). Every function has the signature

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
    op/torch/base.py TorchBackendContext): the graph, the order of its ops,
    the device the executor runs on, and `detail`, a store that lives as
    long as the executor (the device copies of host operands,
    `_device_operand`)."""

    def __init__(self, graph=None, executing_order=None, device=None):
        self.graph = graph
        self.executing_order = executing_order
        self.device = device
        self.detail: Dict[Any, Any] = {}


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


# ============================================================ QDQ dialect ===


def _device_operand(op, idx: int, value, device, ctx) -> torch.Tensor:
    """Input `idx` of `op` as a float32 tensor on `device`. A host operand
    (an integer parameter: a zero point, a weight's integer codes; the
    executors keep these on the host) is uploaded once per host array and
    kept in `ctx.detail`: an upload from pageable memory could not be
    captured into a CUDA graph, and the uncaptured walk that precedes every
    capture (executor/compile.py `_Capture`) fills the store."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    key = ('operand', op.name, idx)
    hit = ctx.detail.get(key) if ctx is not None else None
    if hit is not None and hit[0] is value:
        return hit[1]
    t = torch.as_tensor(np.asarray(value, np.float32), device=device)
    if ctx is not None:
        ctx.detail[key] = (value, t)
    return t


def _zero_point_dtype(values) -> torch.dtype:
    """The output type of QuantizeLinear: its zero point's, int8 without
    one."""
    if not _present(values, 2):
        return torch.int8
    zp = values[2]
    if isinstance(zp, torch.Tensor):
        return zp.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(zp).dtype)).dtype


def _qdq_axis(op, x: torch.Tensor, scale: torch.Tensor) -> Optional[int]:
    """The axis of a per-axis QDQ op (ONNX default 1), None per-tensor."""
    if scale.numel() <= 1:
        return None
    return int(attr(op, 'axis', 1)) % x.ndim


def quantize_linear_plain(x: torch.Tensor, scale: torch.Tensor,
                          zero_point: torch.Tensor, axis: Optional[int],
                          dtype: torch.dtype) -> torch.Tensor:
    """ONNX QuantizeLinear in plain PyTorch, the JAX op's formula
    (ppq_tpu/executor/ops/default.py `QuantizeLinear_forward`):
    saturate(round_half_even(x / scale) + zero_point). The scale is a tensor
    on x's device, so that `x / scale` is the IEEE quotient. The kernel's
    independent twin, for tests."""
    from ...kernels.quant import _broadcast
    info = torch.iinfo(dtype)
    q = torch.round(x / _broadcast(scale, x.ndim, axis)) + \
        _broadcast(zero_point, x.ndim, axis)
    return torch.clamp(q, info.min, info.max).to(dtype)


def quantize_linear(x: torch.Tensor, scale: torch.Tensor,
                    zero_point: torch.Tensor, axis: Optional[int],
                    dtype: torch.dtype) -> torch.Tensor:
    """ONNX QuantizeLinear through the linear fake-quant in its codes mode
    (kernels/quant.py `linear_quant`: the kernel, tensorwise per-tensor and
    channelwise per-axis, on a CUDA tensor; its plain version on a CPU one)
    with the zero point as the offset and the type's range as the clip: it
    returns clip(round(x / s) + zp, lo, hi) - zp, and adding zp back gives
    the ONNX result exactly (integers below 2^24)."""
    from ...core import RoundingPolicy
    from ...kernels.quant import _broadcast, linear_quant
    info = torch.iinfo(dtype)
    scale = scale.reshape(-1) if axis is not None else scale.reshape(())
    zero_point = (zero_point.reshape(-1) if axis is not None
                  else zero_point.reshape(()))
    codes = linear_quant(x.contiguous(), scale, zero_point, float(info.min),
                         float(info.max), RoundingPolicy.ROUND_HALF_EVEN,
                         axis, codes=True)
    return (codes + _broadcast(zero_point, x.ndim, axis)).to(dtype)


def QuantizeLinear_forward(op, values, ctx=None):
    """ONNX QuantizeLinear: y = saturate(round(x / scale) + zero_point),
    needed to run an exported QDQ graph again (reference guarantee:
    tests/test_onnxruntime.py)."""
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    x = _t(values[0]).to(torch.float32)
    scale = _device_operand(op, 1, values[1], x.device, ctx)
    zp = (_device_operand(op, 2, values[2], x.device, ctx)
          if _present(values, 2) else torch.zeros_like(scale))
    return quantize_linear(x, scale, zp, _qdq_axis(op, x, scale),
                           _zero_point_dtype(values))


def _dequantize_params(op, x, values, ctx, axis):
    from ...kernels.quant import _broadcast
    scale = _device_operand(op, 1, values[1], x.device, ctx)
    zp = (_device_operand(op, 2, values[2], x.device, ctx)
          if _present(values, 2) else torch.zeros_like(scale))
    if axis is None or scale.numel() <= 1:
        return scale, zp
    axis = int(axis) % x.ndim
    return _broadcast(scale, x.ndim, axis), _broadcast(zp, x.ndim, axis)


def _qdq_input(op, values, ctx) -> torch.Tensor:
    """Input 0 of a dequantizing op as float32: a tensor where it lies, a
    host operand (a weight's integer codes) on the executor's device."""
    if isinstance(values[0], torch.Tensor):
        device = values[0].device
    elif ctx is not None and ctx.device is not None:
        device = ctx.device
    else:
        raise ValueError(f'{op.type} op {op.name}: a host input needs an '
                         f'ExecContext that names the device')
    return _device_operand(op, 0, values[0], device, ctx)


def DequantizeLinear_forward(op, values, ctx=None):
    """ONNX DequantizeLinear: y = (x - zero_point) * scale, in float32."""
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    x = _qdq_input(op, values, ctx)
    scale, zp = _dequantize_params(op, x, values, ctx, attr(op, 'axis', 1))
    return (x - zp) * scale


def QuantizeFloating_forward(op, values, ctx=None):
    """ppq floating QDQ dialect (reference onnxruntime_exporter.py:113):
    y = clip(fp8_round(x / scale + offset), min, max) kept in float32 —
    there is no guaranteed fp8 initializer type at the exported opset. Plain
    PyTorch, as the JAX op is plain jnp: the fp8 kernel (kernels/floating.py)
    clips before it rounds and returns the value times the scale."""
    from ...kernels.floating import float_round_plain
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    x = _t(values[0]).to(torch.float32)
    scale, zp = _dequantize_params(op, x, values, ctx, attr(op, 'axis'))
    q = float_round_plain(x / scale + zp, int(attr(op, 'exponent', 4)),
                          int(attr(op, 'mantissa', 3)))
    return torch.clamp(q, float(attr(op, 'min', -448.0)),
                       float(attr(op, 'max', 448.0)))


def DequantizeFloating_forward(op, values, ctx=None):
    """Inverse of QuantizeFloating: y = (x - offset) * scale."""
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    x = _qdq_input(op, values, ctx)
    scale, zp = _dequantize_params(op, x, values, ctx, attr(op, 'axis'))
    return (x - zp) * scale


def PPQDeviceSwitch_forward(op, values, ctx=None):
    """Host<->device boundary (reference default.py:3301): 'to_host' hands
    the value on as a host numpy array, 'to_device' as a tensor on the
    executor's device."""
    v = values[0]
    if attr(op, 'direction', 'to_host') == 'to_host':
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    if ctx is None or ctx.device is None:
        raise ValueError(f'{op.type} op {op.name}: to_device needs an '
                         f'ExecContext that names the device')
    return _t(v).to(ctx.device)


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
    'QuantizeLinear': QuantizeLinear_forward,
    'DequantizeLinear': DequantizeLinear_forward,
    'QuantizeFloating': QuantizeFloating_forward,
    'DequantizeFloating': DequantizeFloating_forward,
    'PPQDeviceSwitch': PPQDeviceSwitch_forward,
}
