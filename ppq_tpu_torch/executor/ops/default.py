"""Default op library: ONNX op semantics in PyTorch.

Port of ppq_tpu/executor/ops/default.py, the whole of its
DEFAULT_BACKEND_TABLE (129 op types), under the same names (`<Op>_forward`);
each function's docstring or section names its JAX counterpart's lines.
Every function has the signature

    f(op: Operation, values: List[Tensor | ndarray], ctx: ExecContext) -> Tensor

Values are torch tensors on the executor's device (activations and float
parameters) or host numpy arrays (shape and index operands, integer
parameters). An op runs on the device of its first input that is a tensor on
a card (`_device`), and on the CPU when every input lies on the host; a host
operand that joins a card tensor is uploaded once per op input and contents
and kept in `ctx.detail` (`_upload`), so that a CUDA graph captured after
the first walk holds no upload. A shape-or-index operand is read on the host
(`_host`), which refuses a card tensor: nothing here reads the card back,
apart from NonZero and NonMaxSuppression, whose output shapes depend on
the data (`_readback`; the compiled executor does not take them). Ops that
compute on host values only return host numpy arrays, as the JAX package's
do: Shape, Size, ConstantOfShape, Range, NonZero, NonMaxSuppression,
Constant, Parameter, and Cast of a host array.

Convolutions and matrix products stay library calls (`torch.nn.functional.
conv*d`, `torch.matmul`, `torch.einsum`), as the JAX package leaves them to
XLA; the rest is composed of PyTorch tensor ops. A division by a number goes
through a tensor (`_full`): PyTorch's CUDA division by a host number
multiplies by its reciprocal, which is not the IEEE quotient the JAX package
computes.

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

Where the port differs from the JAX package (ROADMAP.md queue 3): integer
results are int64 where the JAX package (x64 off) gives int32; TopK breaks
ties toward the lower index by a stable sort and keeps its indices on the
device; a float64 operand or Cast target is float32, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...core import DataType


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
    long as the executor (the device copies of host operands, `_upload`)."""

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


def _text(v):
    return v.decode() if isinstance(v, bytes) else v


# ================================================ host and device operands ===
# (JAX: default.py:99-120 `_np`, `_present`)


def _present(values, idx) -> bool:
    """Optional input present and non-empty."""
    if len(values) <= idx or values[idx] is None:
        return False
    v = values[idx]
    return (v.numel() if isinstance(v, torch.Tensor) else np.size(v)) > 0


def _device(values) -> torch.device:
    """The device an op runs on: that of its first input that is a tensor on
    a card, else the CPU."""
    for v in values:
        if isinstance(v, torch.Tensor) and v.device.type != 'cpu':
            return v.device
    return torch.device('cpu')


def _host(op, v) -> np.ndarray:
    """A shape-or-index operand (the JAX package's `_np`) as a host array. A
    tensor on a card is refused: its value would need a synchronising read,
    which a CUDA graph cannot hold."""
    if isinstance(v, torch.Tensor):
        if v.device.type != 'cpu':
            raise RuntimeError(
                f'{op.type} op {op.name}: a shape or index operand lies on '
                f'the card; the op library reads these on the host only')
        return v.numpy()
    return np.asarray(v)


def _readback(v) -> np.ndarray:
    """Read a value back to the host, for the ops whose output shape depends
    on the data (NonZero, NonMaxSuppression) and only for them."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _host_array(v) -> np.ndarray:
    a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    if a.dtype == np.float64:      # the JAX package's default: x64 off
        a = a.astype(np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return a


def _upload(value, device: torch.device, ctx=None, key=None,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (or a CPU tensor) as a tensor on `device`, of `dtype`
    where given; float64 comes as float32. On a card the copy is kept in
    `ctx.detail[key]` and reused while the host value is the same object or
    has the same contents: an upload from pageable memory cannot be
    captured into a CUDA graph, and the uncaptured walk that precedes every
    capture (executor/compile.py `_Capture`) fills the store."""
    if isinstance(value, torch.Tensor) and value.device == device:
        return value if dtype is None else value.to(dtype)
    if device.type == 'cpu' or ctx is None or key is None:
        t = torch.as_tensor(_host_array(value), device=device)
        return t if dtype is None else t.to(dtype)
    hit = ctx.detail.get(key)
    if hit is not None and hit[0] is value and hit[2].device == device:
        return hit[2]
    a = _host_array(value)
    if hit is not None and hit[2].device == device and \
            hit[1].shape == a.shape and hit[1].dtype == a.dtype and \
            np.array_equal(hit[1], a):
        return hit[2]
    t = torch.as_tensor(a, device=device)
    t = t if dtype is None else t.to(dtype)
    ctx.detail[key] = (value, a, t)
    return t


def _arg(op, values, idx, ctx, device,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Input `idx` of `op` as a tensor on `device`, of `dtype` where given
    (`_upload`)."""
    return _upload(values[idx], device, ctx, ('operand', op.name, idx), dtype)


def _full(value, like: torch.Tensor) -> torch.Tensor:
    """A number as a 0-d tensor of `like`'s type on its device, made by a
    fill kernel: a divisor that keeps the IEEE quotient on every device."""
    dtype = like.dtype if like.is_floating_point() else torch.float32
    return torch.full((), value, dtype=dtype, device=like.device)


def _f32(value, device) -> torch.Tensor:
    """A number as a float32 0-d tensor on `device` (see `_full`)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _sum(x, dims, keepdim=False):
    return torch.sum(x, dim=dims, keepdim=keepdim)


def _mean(x: torch.Tensor, dims, keepdim=False) -> torch.Tensor:
    """jnp.mean: the sum divided by the count (an IEEE quotient)."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    dims = tuple(range(x.ndim)) if dims is None else \
        tuple(d % x.ndim for d in dims)
    if not dims:
        return x
    count = int(np.prod([x.shape[d] for d in dims]))
    return _sum(x, dims, keepdim) / _full(float(count), x)


def _var(x: torch.Tensor, dims, keepdim=False) -> torch.Tensor:
    """jnp.var: the mean of the squared deviation from the mean."""
    c = x - _mean(x, dims, keepdim=True)
    return _mean(c * c, dims, keepdim)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace along a new last axis (start * (1 - step) + stop * step,
    step = i / (num - 1), the endpoint appended), for start / stop tensors
    of one shape."""
    start, stop = start[..., None], stop[..., None]
    if num == 1:
        return start
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / \
        _full(float(div), start)
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop], dim=-1)


# ============================================================ conv family ===


def _conv_padding(op, spatial_rank: int, x_shape, w_shape, strides, dilations):
    auto_pad = _text(attr(op, 'auto_pad', 'NOTSET'))
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
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _channel_bias(y, b):
    return y + b.reshape((1, -1) + (1,) * (y.ndim - 2))


def Conv_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    dev = _device(values)
    x, w = _arg(op, values, 0, ctx, dev), _arg(op, values, 1, ctx, dev)
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
    bias = _arg(op, values, 2, ctx, dev) if _present(values, 2) else None
    return _CONV[spatial](x, w, bias, stride=strides, padding=padding,
                          dilation=dilations, groups=group)


def ConvTranspose_forward(op, values, ctx=None):
    """(JAX: default.py:173-216.) The full transposed convolution, then the
    ONNX pads cut from each end and `output_padding` added at the far end
    (F.pad with negative widths crops): the JAX package's lhs-dilated
    convolution padded (k - 1 - p_begin, k - 1 - p_end + output_padding)."""
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    dev = _device(values)
    x, w = _arg(op, values, 0, ctx, dev), _arg(op, values, 1, ctx, dev)
    spatial = x.ndim - 2
    group = int(attr(op, 'group', 1))
    strides = [int(s) for s in attr(op, 'strides', [1] * spatial)]
    dilations = [int(d) for d in attr(op, 'dilations', [1] * spatial)]
    p = attr(op, 'pads', [0] * 2 * spatial)
    out_pads = [int(v) for v in attr(op, 'output_padding', [0] * spatial)]
    y = _CONV_T[spatial](x, w, None, stride=strides, padding=0,
                         groups=group, dilation=dilations)
    crop = []
    for i in reversed(range(spatial)):
        crop += [-int(p[i]), -int(p[i + spatial]) + out_pads[i]]
    if any(crop):
        y = F.pad(y, crop)
    if _present(values, 2):
        y = _channel_bias(y, _arg(op, values, 2, ctx, dev))
    return y


# ============================================================ pool family ===


def _pool_pads(op, x):
    """(JAX: default.py:222-239 `_pool`.) Kernel, strides and the padding
    per spatial dim, ceil_mode's extra padding at the end included."""
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
    return k, strides, pads


def MaxPool_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    k, strides, pads = _pool_pads(op, x)
    if any(b or e for b, e in pads):
        x = F.pad(x, _pad_spec(pads), value=-float('inf'))
    return _MAX_POOL[x.ndim - 2](x, k, strides)


def _window_sum(x, k, strides, pads):
    """The sum over each pooling window of x padded with zeros."""
    if any(b or e for b, e in pads):
        x = F.pad(x, _pad_spec(pads))
    if x.ndim == 3:                  # lift 1-D to 2-D
        return F.avg_pool2d(x[..., None], k + [1], strides + [1],
                            divisor_override=1)[..., 0]
    pool = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return pool(x, k, strides, divisor_override=1)


def AveragePool_forward(op, values, ctx=None):
    """(JAX: default.py:248-256.) The window sum divided by the kernel's
    size, or, with `count_include_pad` 0 and padding, by the count of the
    window's elements that are not padding (ceil_mode's padding counts as
    padding)."""
    x = _arg(op, values, 0, ctx, _device(values))
    include_pad = int(attr(op, 'count_include_pad', 0))
    k, strides, pads = _pool_pads(op, x)
    y = _window_sum(x, k, strides, pads)
    if include_pad or all(p == (0, 0) for p in pads):
        return y / _full(float(np.prod(k)), y)
    cnt = _window_sum(torch.ones_like(x), k, strides, pads)
    return y / cnt


def GlobalAveragePool_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


def GlobalMaxPool_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.amax(x, dim=tuple(range(2, x.ndim)), keepdim=True)


# ========================================================== linear algebra ===


def Gemm_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 2, 3)
    dev = _device(values)
    a, b = _arg(op, values, 0, ctx, dev), _arg(op, values, 1, ctx, dev)
    if int(attr(op, 'transA', 0)):
        a = a.T
    if int(attr(op, 'transB', 0)):
        b = b.T
    y = torch.matmul(a, b) * float(attr(op, 'alpha', 1.0))
    if len(values) > 2 and values[2] is not None:
        y = y + _arg(op, values, 2, ctx, dev) * float(attr(op, 'beta', 1.0))
    return y


def MatMul_forward(op, values, ctx=None):
    dev = _device(values)
    return torch.matmul(_arg(op, values, 0, ctx, dev),
                        _arg(op, values, 1, ctx, dev))


def PPQBiasFusedMatMul_forward(op, values, ctx=None):
    dev = _device(values)
    y = torch.matmul(_arg(op, values, 0, ctx, dev),
                     _arg(op, values, 1, ctx, dev))
    if len(values) > 2 and values[2] is not None:
        y = y + _arg(op, values, 2, ctx, dev)
    return y


def Einsum_forward(op, values, ctx=None):
    """(JAX: default.py:1011-1016.)"""
    dev = _device(values)
    return torch.einsum(_text(attr(op, 'equation')),
                        *[_arg(op, values, i, ctx, dev)
                          for i in range(len(values))])


# ============================================================ elementwise ===
# (JAX: default.py:302-406)


def _binary(fn):
    def f(op, values, ctx=None):
        ASSERT_NUM_OF_INPUT(op, values, 2)
        dev = _device(values)
        return fn(_arg(op, values, 0, ctx, dev), _arg(op, values, 1, ctx, dev))
    return f


def _unary(fn):
    def f(op, values, ctx=None):
        ASSERT_NUM_OF_INPUT(op, values, 1)
        return fn(_arg(op, values, 0, ctx, _device(values)))
    return f


def _variadic(fn):
    def f(op, values, ctx=None):
        dev = _device(values)
        return functools.reduce(fn, [_arg(op, values, i, ctx, dev)
                                     for i in range(len(values))])
    return f


def _true_divide(a, b):
    return a / b


def _mod(a, b):
    """jnp.mod: the truncated remainder, moved into the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sigmoid(x):
    return torch.sigmoid(x)


def _gelu(x):
    """jax.nn.gelu(approximate=False): 0.5 x erfc(-x sqrt(1/2)). The JAX
    package reads no `approximate` attribute, so neither does the port."""
    return 0.5 * x * torch.special.erfc(-x * float(np.float32(np.sqrt(0.5))))


Add_forward = _binary(torch.add)
Sub_forward = _binary(torch.sub)
Mul_forward = _binary(torch.mul)
Div_forward = _binary(_true_divide)
Pow_forward = _binary(torch.pow)
Mod_forward = _binary(_mod)
Max_forward = _variadic(torch.maximum)
Min_forward = _variadic(torch.minimum)
Sum_forward = _variadic(torch.add)

Relu_forward = _unary(torch.relu)
Sigmoid_forward = _unary(_sigmoid)
Tanh_forward = _unary(torch.tanh)
Exp_forward = _unary(torch.exp)
Log_forward = _unary(torch.log)
Sqrt_forward = _unary(torch.sqrt)
Reciprocal_forward = _unary(torch.reciprocal)
Abs_forward = _unary(torch.abs)
Neg_forward = _unary(torch.neg)
Floor_forward = _unary(torch.floor)
Ceil_forward = _unary(torch.ceil)
Round_forward = _unary(torch.round)         # half to even, as jnp.round
Sign_forward = _unary(torch.sign)
Erf_forward = _unary(torch.erf)
Sin_forward = _unary(torch.sin)
Cos_forward = _unary(torch.cos)
Tan_forward = _unary(torch.tan)
Not_forward = _unary(torch.logical_not)
Softplus_forward = _unary(_softplus)
Mish_forward = _unary(lambda x: x * torch.tanh(_softplus(x)))
Swish_forward = _unary(lambda x: x * _sigmoid(x))
SiLU_forward = Swish_forward
Gelu_forward = _unary(_gelu)
HardSwish_forward = _unary(
    lambda x: x * torch.clamp(x / _full(6.0, x) + 0.5, 0.0, 1.0))
Identity_forward = _unary(lambda x: x)


def HardSigmoid_forward(op, values, ctx=None):
    alpha = float(attr(op, 'alpha', 0.2))
    beta = float(attr(op, 'beta', 0.5))
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.clamp(alpha * x + beta, 0.0, 1.0)


def LeakyRelu_forward(op, values, ctx=None):
    alpha = float(attr(op, 'alpha', 0.01))
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.where(x >= 0, x, alpha * x)


def PRelu_forward(op, values, ctx=None):
    dev = _device(values)
    x, slope = _arg(op, values, 0, ctx, dev), _arg(op, values, 1, ctx, dev)
    if slope.ndim == 1 and x.ndim > 1:
        slope = slope.reshape((1, -1) + (1,) * (x.ndim - 2))
    return torch.where(x >= 0, x, slope * x)


def Clip_forward(op, values, ctx=None):
    """jnp.clip(x, lo, hi): the bounds may be tensors on the card (float
    parameters), which torch.clamp takes as they are."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    lo = _arg(op, values, 1, ctx, dev).to(x.dtype) if _present(values, 1) \
        else None
    hi = _arg(op, values, 2, ctx, dev).to(x.dtype) if _present(values, 2) \
        else None
    if lo is None and hi is None:
        return x
    return torch.clamp(x, min=lo, max=hi)


def Elu_forward(op, values, ctx=None):
    alpha = float(attr(op, 'alpha', 1.0))
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def Selu_forward(op, values, ctx=None):
    alpha = float(attr(op, 'alpha', 1.6732632423543772))
    gamma = float(attr(op, 'gamma', 1.0507009873554805))
    x = _arg(op, values, 0, ctx, _device(values))
    return gamma * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


# comparison / logic (outputs bool)
Equal_forward = _binary(torch.eq)
Greater_forward = _binary(torch.gt)
GreaterOrEqual_forward = _binary(torch.ge)
Less_forward = _binary(torch.lt)
LessOrEqual_forward = _binary(torch.le)
And_forward = _binary(torch.logical_and)
Or_forward = _binary(torch.logical_or)
Xor_forward = _binary(torch.logical_xor)


def Where_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 3)
    dev = _device(values)
    return torch.where(_arg(op, values, 0, ctx, dev).to(torch.bool),
                       _arg(op, values, 1, ctx, dev),
                       _arg(op, values, 2, ctx, dev))


# ============================================================== softmax etc ===
# (JAX: default.py:411-427)


def Softmax_forward(op, values, ctx=None):
    axis = int(attr(op, 'axis', -1))
    return torch.softmax(_arg(op, values, 0, ctx, _device(values)), dim=axis)


def LogSoftmax_forward(op, values, ctx=None):
    axis = int(attr(op, 'axis', -1))
    return torch.log_softmax(_arg(op, values, 0, ctx, _device(values)),
                             dim=axis)


def Softmax_opset11_forward(op, values, ctx=None):
    """opset < 13: the dims from `axis` on are flattened into one, over which
    the softmax runs (the JAX package defines it and registers none)."""
    axis = int(attr(op, 'axis', 1))
    x = _arg(op, values, 0, ctx, _device(values))
    shape = x.shape
    flat = x.reshape(int(np.prod(shape[:axis])), -1)
    return torch.softmax(flat, dim=-1).reshape(shape)


# =============================================================== norms ===
# (JAX: default.py:433-495)


def BatchNormalization_forward(op, values, ctx=None):
    ASSERT_NUM_OF_INPUT(op, values, 5)
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    gamma, beta, mean, var = (_arg(op, values, i, ctx, dev)
                              for i in range(1, 5))
    eps = float(attr(op, 'epsilon', 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            * gamma.reshape(shape) + beta.reshape(shape))


def LayerNormalization_forward(op, values, ctx=None):
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    axis = int(attr(op, 'axis', -1))
    eps = float(attr(op, 'epsilon', 1e-5))
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = _mean(x, axes, keepdim=True)
    var = _var(x, axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    if _present(values, 1):
        y = y * _arg(op, values, 1, ctx, dev)
    if _present(values, 2):
        y = y + _arg(op, values, 2, ctx, dev)
    return y


def InstanceNormalization_forward(op, values, ctx=None):
    dev = _device(values)
    x, gamma, beta = (_arg(op, values, i, ctx, dev) for i in range(3))
    eps = float(attr(op, 'epsilon', 1e-5))
    axes = tuple(range(2, x.ndim))
    mean = _mean(x, axes, keepdim=True)
    var = _var(x, axes, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean) / torch.sqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


def GroupNormalization_forward(op, values, ctx=None):
    dev = _device(values)
    x, gamma, beta = (_arg(op, values, i, ctx, dev) for i in range(3))
    eps = float(attr(op, 'epsilon', 1e-5))
    groups = int(attr(op, 'num_groups', 1))
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    mean = _mean(xg, axes, keepdim=True)
    var = _var(xg, axes, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * gamma.reshape(shape) + beta.reshape(shape)


def LRN_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    size = int(attr(op, 'size'))
    alpha = float(attr(op, 'alpha', 1e-4))
    beta = float(attr(op, 'beta', 0.75))
    bias = float(attr(op, 'k', 1.0))
    sq = x * x
    half = size // 2
    sq_pad = F.pad(sq, [0, 0] * (x.ndim - 2) + [half, size - 1 - half])
    window = sq_pad.unfold(1, size, 1).sum(-1)
    return x / torch.pow(bias + alpha * window / _full(float(size), x), beta)


def SkipLayerNorm_forward(op, values, ctx=None):
    """TensorRT skipLayerNormPlugin: LN(x + skip) (JAX: default.py:1370-1379;
    reference fuse_skiplayernorm target, IR/morph.py:821)."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev) + _arg(op, values, 1, ctx, dev)
    gamma = _arg(op, values, 2, ctx, dev)
    beta = _arg(op, values, 3, ctx, dev) if _present(values, 3) else 0.0
    eps = float(attr(op, 'epsilon', 1e-5))
    mean = _mean(x, (-1,), keepdim=True)
    var = _var(x, (-1,), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


# ======================================================== shape / movement ===
# (JAX: default.py:501-631, 763-788, 1341-1347)


def Reshape_forward(op, values, ctx=None):
    """The target shape is a host operand (an SOI input); 0 copies the
    input's dimension unless `allowzero`."""
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    shape = [int(v) for v in _host(op, values[1]).reshape(-1)]
    if not int(attr(op, 'allowzero', 0)):
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def Flatten_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    axis = int(attr(op, 'axis', 1))
    lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
    return x.reshape(lead, -1)


def Transpose_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    perm = attr(op, 'perm', list(reversed(range(x.ndim))))
    return x.permute([int(p) for p in perm])


def Squeeze_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    if _present(values, 1):
        axes = sorted({int(a) % x.ndim
                       for a in _host(op, values[1]).reshape(-1)})
        for a in reversed(axes):
            if x.shape[a] != 1:
                raise ValueError(f'{op.type} op {op.name}: axis {a} of shape '
                                 f'{tuple(x.shape)} is not 1')
            x = x.squeeze(a)
        return x
    return x.reshape([d for d in x.shape if d != 1])


def Unsqueeze_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    given = _host(op, values[1]).reshape(-1)
    for a in sorted(int(a) % (x.ndim + len(given)) for a in given):
        x = x.unsqueeze(a)
    return x


def _numel(v) -> int:
    return v.numel() if isinstance(v, torch.Tensor) else int(np.size(v))


def Concat_forward(op, values, ctx=None):
    axis = int(attr(op, 'axis'))
    dev = _device(values)
    keep = [i for i, v in enumerate(values) if _numel(v) > 0] or \
        list(range(len(values)))
    return torch.cat([_arg(op, values, i, ctx, dev) for i in keep], dim=axis)


def Split_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    axis = int(attr(op, 'axis', 0))
    sizes = None
    if _present(values, 1):
        sizes = [int(s) for s in _host(op, values[1]).reshape(-1)]
    elif attr(op, 'split', None) is not None:
        # legacy opset<13 attribute; the caffe frontend also uses it with
        # a -1 tail (caffe slice_point doesn't record the last extent)
        sizes = [int(s) for s in attr(op, 'split')]
    if sizes is not None:
        if any(s < 0 for s in sizes):
            rem = int(x.shape[axis]) - sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else rem for s in sizes]
        if sum(sizes) != x.shape[axis]:
            raise ValueError(f'{op.type} op {op.name}: sizes {sizes} do not '
                             f'add up to {x.shape[axis]}')
        return tuple(torch.split(x, sizes, dim=axis))
    n_out = len(op.outputs) if op.outputs else int(attr(op, 'num_outputs', 2))
    if x.shape[axis] % n_out:
        raise ValueError(f'{op.type} op {op.name}: {x.shape[axis]} does not '
                         f'split into {n_out} equal parts')
    return tuple(torch.split(x, x.shape[axis] // n_out, dim=axis))


def Slice_forward(op, values, ctx=None):
    """The JAX package's bounds (clamped starts and ends, negative steps),
    then numpy's slice semantics; a negative step reads the flipped axis."""
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    starts = _host(op, values[1]).reshape(-1).astype(np.int64)
    ends = _host(op, values[2]).reshape(-1).astype(np.int64)
    axes = (_host(op, values[3]).reshape(-1).astype(np.int64)
            if _present(values, 3) else np.arange(len(starts)))
    steps = (_host(op, values[4]).reshape(-1).astype(np.int64)
             if _present(values, 4) else np.ones(len(starts), np.int64))
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % x.ndim
        dim = x.shape[a]
        s, e, st = int(s), int(e), int(st)
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        if e < -dim:
            e = -dim - 1 if st < 0 else 0
        e = e + dim if e < 0 else min(e, dim) if st > 0 else min(e, dim - 1)
        first, _, step = slice(s, e, st).indices(dim)
        count = len(range(*slice(s, e, st).indices(dim)))
        if step < 0:
            x, first, step = x.flip(a), dim - 1 - first, -step
        x = x.narrow(a, first, max(0, (count - 1) * step + 1) if count else 0)
        if step > 1:
            x = x[(slice(None),) * a + (slice(None, None, step),)]
    return x


_PAD_MODES = {'reflect': 'reflect', 'edge': 'edge', 'wrap': 'wrap'}


def Pad_forward(op, values, ctx=None):
    """jnp.pad: constant (the value may be a tensor on the card), reflect,
    edge and wrap; the last three gather each padded axis through numpy's
    own index padding, so wide pads repeat as numpy's do."""
    dev = _device(values[:1] + values[2:3])
    x = _arg(op, values, 0, ctx, dev)
    mode = _text(attr(op, 'mode', 'constant'))
    pads = _host(op, values[1]).reshape(-1).astype(np.int64)
    n = x.ndim
    pad_width = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if mode == 'constant':
        spec = _pad_spec(pad_width)
        if not _present(values, 2):
            return F.pad(x, spec, value=0.0)
        cval = values[2]
        if not (isinstance(cval, torch.Tensor) and cval.device.type != 'cpu'):
            return F.pad(x, spec,
                         value=float(_host(op, cval).reshape(-1)[0]))
        inner = F.pad(torch.ones(x.shape, dtype=torch.uint8, device=dev),
                      spec)
        return torch.where(inner.to(torch.bool), F.pad(x, spec),
                           cval.reshape(-1)[0].to(x.dtype))
    np_mode = _PAD_MODES[mode]
    for a, (b, e) in enumerate(pad_width):
        if b or e:
            idx = np.pad(np.arange(x.shape[a]), (b, e), mode=np_mode)
            x = torch.index_select(x, a, _upload(
                np.asarray(idx), dev, ctx, ('const', op.name, 'pad', a)))
    return x


def Expand_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    shape = [int(v) for v in _host(op, values[1]).reshape(-1)]
    # ONNX Expand = numpy broadcast of input against `shape`: dimensions
    # right-aligned, a shape entry of 1 keeps the input dim (the spec has
    # no -1; tolerate it as 1 for models that use the torch convention)
    ndim = max(len(shape), x.ndim)
    in_shape = (1,) * (ndim - x.ndim) + tuple(x.shape)
    sh = [1] * (ndim - len(shape)) + [1 if s == -1 else s for s in shape]
    target = [max(a, b) for a, b in zip(in_shape, sh)]
    return x.reshape(in_shape).expand(target)


def Tile_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    reps = [int(v) for v in _host(op, values[1]).reshape(-1)]
    # ONNX requires len(reps) == rank; the caffe frontend can emit reps for
    # leading axes only (Tile layer's axis/tiles) — treat reps as
    # LEFT-aligned and pad/truncate with 1s
    if len(reps) < x.ndim:
        reps = reps + [1] * (x.ndim - len(reps))
    elif len(reps) > x.ndim:
        reps = reps[:x.ndim]
    return x.repeat(reps)


def DepthToSpace_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    bs = int(attr(op, 'blocksize'))
    mode = _text(attr(op, 'mode', 'DCR'))
    n, c, h, w = x.shape
    if mode == 'DCR':
        y = x.reshape(n, bs, bs, c // (bs * bs), h, w)
        y = y.permute(0, 3, 4, 1, 5, 2)
    else:
        y = x.reshape(n, c // (bs * bs), bs, bs, h, w)
        y = y.permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, c // (bs * bs), h * bs, w * bs)


def SpaceToDepth_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    bs = int(attr(op, 'blocksize'))
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // bs, bs, w // bs, bs)
    y = y.permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * bs * bs, h // bs, w // bs)


def ChannelShuffle_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    g = int(attr(op, 'group', attr(op, 'groups', 1)))
    n, c, h, w = x.shape
    return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)


# ===================================================== indexing and types ===
# (JAX: default.py:639-720, 996-1008)


def _indices(op, values, idx, ctx, dev, dim=None) -> torch.Tensor:
    """An index operand as int64 on `dev` (host indices are uploaded as
    operands are; runtime indices, such as token ids fed to the graph, stay
    where they are); with `dim`, negative indices count from its end."""
    i = _arg(op, values, idx, ctx, dev).to(torch.int64)
    if dim is not None:
        i = torch.where(i < 0, i + dim, i)
    return i


def Gather_forward(op, values, ctx=None):
    """jnp.take along `axis`."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    axis = int(attr(op, 'axis', 0)) % x.ndim
    idx = _indices(op, values, 1, ctx, dev, x.shape[axis])
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def GatherElements_forward(op, values, ctx=None):
    """jnp.take_along_axis."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    axis = int(attr(op, 'axis', 0)) % x.ndim
    return torch.gather(x, axis,
                        _indices(op, values, 1, ctx, dev, x.shape[axis]))


def GatherND_forward(op, values, ctx=None):
    """ONNX GatherND; `batch_dims` b flattens the leading b dims and
    prepends each row's batch index to its index tuple (the JAX package's
    construction, here on the device)."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    idx = _indices(op, values, 1, ctx, dev)
    b = int(attr(op, 'batch_dims', 0))
    if b:
        batch_shape = tuple(x.shape[:b])
        nb = int(np.prod(batch_shape))
        xf = x.reshape((nb,) + tuple(x.shape[b:]))
        idxf = idx.reshape((nb,) + tuple(idx.shape[b:]))
        rows = torch.arange(nb, device=dev).reshape(
            (nb,) + (1,) * (idxf.ndim - 2)).expand(idxf.shape[:-1])
        idx2 = torch.cat([rows[..., None], idxf], dim=-1)
        k = idxf.shape[-1]
        flat = idx2.reshape(-1, k + 1)
        out = xf[tuple(flat[:, i] for i in range(k + 1))]
        return out.reshape(batch_shape + tuple(idxf.shape[1:-1])
                           + tuple(xf.shape[1 + k:]))
    last = idx.shape[-1]
    flat = idx.reshape(-1, last)
    out = x[tuple(flat[:, i] for i in range(last))]
    return out.reshape(tuple(idx.shape[:-1]) + tuple(x.shape[last:]))


def ScatterND_forward(op, values, ctx=None):
    """x.at[index tuples].set(updates). ONNX leaves duplicate indices
    undefined (reduction 'none'); with them, which update lands is not
    fixed on either package's device."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    idx = _indices(op, values, 1, ctx, dev)
    updates = _arg(op, values, 2, ctx, dev).to(x.dtype)
    y = x.clone()
    y[tuple(idx[..., i] for i in range(idx.shape[-1]))] = updates
    return y


def ScatterElements_forward(op, values, ctx=None):
    """x with updates written at `indices` along `axis` (unique indices, as
    ONNX requires for reduction 'none')."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    axis = int(attr(op, 'axis', 0)) % x.ndim
    idx = _indices(op, values, 1, ctx, dev, x.shape[axis])
    updates = _arg(op, values, 2, ctx, dev).to(x.dtype)
    return x.clone().scatter_(axis, idx, updates)


_TORCH_TYPES = {
    DataType.FP32: torch.float32, DataType.FP64: torch.float32,
    DataType.FP16: torch.float16, DataType.BF16: torch.bfloat16,
    DataType.INT8: torch.int8, DataType.UINT8: torch.uint8,
    DataType.INT16: torch.int16, DataType.INT32: torch.int32,
    DataType.INT64: torch.int64, DataType.BOOL: torch.bool,
    DataType.FP8_E4M3: torch.float8_e4m3fn,
    DataType.FP8_E5M2: torch.float8_e5m2,
}


def _saturating_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float to integer as XLA converts: toward zero, NaN to 0, values out of
    the type's range to its nearest end."""
    info = torch.iinfo(dtype)
    t = torch.trunc(x.to(torch.float64))
    t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
    if dtype != torch.int64:
        return torch.clamp(t, float(info.min), float(info.max)).to(dtype)
    top = 2.0 ** 63                # the first float64 above int64's range
    y = torch.clamp(t, -top, top - 1024.0).to(dtype)
    return torch.where(t >= top, torch.full_like(y, info.max), y)


def Cast_forward(op, values, ctx=None):
    """(JAX: default.py:712-718.) A host array is cast by numpy, as the JAX
    package casts it; a tensor by torch, float to integer saturating as XLA
    does. A tensor cast to INT64 is int64 (the JAX package's is int32), to
    DOUBLE float32 (as the JAX package's)."""
    to = DataType(int(attr(op, 'to')))
    x = values[0]
    if not isinstance(x, torch.Tensor):
        return np.asarray(x).astype(to.to_numpy())
    if to not in _TORCH_TYPES:
        raise NotImplementedError(f'{op.type} op {op.name}: no torch type '
                                  f'for {to.name}')
    dtype = _TORCH_TYPES[to]
    if x.is_floating_point() and not dtype.is_floating_point and \
            dtype != torch.bool:
        return _saturating_cast(x, dtype)
    return x.to(dtype)


def CumSum_forward(op, values, ctx=None):
    """jnp.cumsum along the axis operand (the JAX package reads neither
    `exclusive` nor `reverse`)."""
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    return torch.cumsum(x, dim=int(_host(op, values[1]).reshape(-1)[0]))


def OneHot_forward(op, values, ctx=None):
    """jax.nn.one_hot(indices % depth, depth, axis) * (on - off) + off."""
    dev = _device(values)
    idx = _indices(op, values, 0, ctx, dev)
    depth = int(_host(op, values[1]).reshape(-1)[0])
    vals = _arg(op, values, 2, ctx, dev).reshape(-1)
    off_v, on_v = vals[0], vals[1]
    axis = int(attr(op, 'axis', -1)) % (idx.ndim + 1)
    eye = F.one_hot(torch.remainder(idx, depth), depth).to(torch.float32)
    eye = eye.movedim(-1, axis)
    return eye * (on_v - off_v) + off_v


# ===================================================== resize and upsample ===
# (JAX: default.py:721-762; jax.image.resize, ported)


def _keys_cubic(x):
    """jax.image's Keys cubic kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0.0)


def _resize_weights(m: int, n: int, kernel, like: torch.Tensor):
    """jax.image `compute_weight_mat`: the (m, n) resampling weights of one
    axis at scale n / m, translation 0, antialiased (a kernel widened by the
    scale's inverse when it downscales), each column normalised, columns
    whose sample lies outside the input zero."""
    f32 = torch.float32
    dev = like.device
    # a Python float in the JAX package: 1 / (n / m) in float64, used as
    # float32
    inv_scale = float(np.float32(1.0 / (n / m)))
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=f32, device=dev) + 0.5) * inv_scale \
        - 0.5
    x = torch.abs(sample_f[None, :] -
                  torch.arange(m, dtype=f32, device=dev)[:, None]) / \
        _f32(kernel_scale, dev)
    weights = kernel(x)
    total = torch.sum(weights, dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        torch.abs(total) > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _image_resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """jax.image.resize(x, shape, method) for 'nearest', 'bilinear' and
    'bicubic': nearest samples the input at floor((i + 0.5) * m / n), the
    half-pixel centres; linear and cubic contract each resized axis with
    its weight matrix, in float32."""
    dims = [d for d in range(x.ndim) if x.shape[d] != shape[d]]
    if method == 'nearest':
        for d in dims:
            m, n = x.shape[d], shape[d]
            pos = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * float(m) / _f32(float(n), x.device)
            x = torch.index_select(x, d, torch.floor(pos).to(torch.int64))
        return x
    kernel = _triangle if method == 'bilinear' else _keys_cubic
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d in dims:
        w = _resize_weights(x.shape[d], shape[d], kernel, x).to(x.dtype)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


def _resize_align_corners(x, sizes):
    """(JAX: default.py:744-756.) Linear interpolation at
    linspace(0, n_in - 1, n_out), axis by axis from the third on."""
    out = x
    for axis in range(2, x.ndim):
        n_in, n_out = x.shape[axis], sizes[axis]
        if n_in == n_out:
            continue
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        pos = _linspace(zero, zero + float(n_in - 1), n_out)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.clamp(lo + 1, max=n_in - 1)
        w = (pos - lo).reshape((-1,) + (1,) * (x.ndim - axis - 1))
        out = (torch.index_select(out, axis, lo) * (1 - w)
               + torch.index_select(out, axis, hi) * w)
    return out


def Resize_forward(op, values, ctx=None):
    """(JAX: default.py:721-741.) The output size from `sizes`, else from
    floor(dim * scale); the JAX package's jax.image.resize ignores
    `coordinate_transformation_mode` except 'align_corners' (linear and
    cubic alike then interpolate linearly), and the port computes the
    same."""
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    mode = _text(attr(op, 'mode', 'nearest'))
    coord = _text(attr(op, 'coordinate_transformation_mode', 'half_pixel'))
    sizes = None
    if _present(values, 3):
        sizes = [int(v) for v in _host(op, values[3]).reshape(-1)]
    elif _present(values, 2):
        scales = _host(op, values[2]).reshape(-1)
        sizes = [int(np.floor(d * s)) for d, s in zip(x.shape, scales)]
    if sizes is None:
        return x
    method = {'nearest': 'nearest', 'linear': 'bilinear',
              'cubic': 'bicubic'}[mode]
    if coord == 'align_corners' and method != 'nearest':
        return _resize_align_corners(x, sizes)
    return _image_resize(x, sizes, method)


def Upsample_forward(op, values, ctx=None):
    return Resize_forward(
        op, [values[0], None, values[1] if len(values) > 1 else None], ctx)


# ============================================================== reductions ===
# (JAX: default.py:789-830)


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn):
    def f(op, values, ctx=None):
        x = _arg(op, values, 0, ctx, _device(values[:1]))
        if _present(values, 1):             # opset 18 axes-as-input
            axes = tuple(int(a) for a in _host(op, values[1]).reshape(-1))
        else:
            axes_attr = attr(op, 'axes')
            axes = tuple(int(a) for a in axes_attr) \
                if axes_attr is not None else None
        keepdims = bool(attr(op, 'keepdims', 1))
        dims = tuple(range(x.ndim)) if axes is None else \
            tuple(a % x.ndim for a in axes)
        return fn(x, dims, keepdims)
    return f


ReduceMean_forward = _reduce(_mean)
ReduceSum_forward = _reduce(_sum)
ReduceMax_forward = _reduce(lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
ReduceMin_forward = _reduce(lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
ReduceProd_forward = _reduce(_prod)
ReduceL2_forward = _reduce(lambda x, d, k: torch.sqrt(_sum(x * x, d, k)))
ReduceL1_forward = _reduce(lambda x, d, k: _sum(torch.abs(x), d, k))
ReduceSumSquare_forward = _reduce(lambda x, d, k: _sum(x * x, d, k))


def ArgMax_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.argmax(x, dim=int(attr(op, 'axis', 0)),
                        keepdim=bool(attr(op, 'keepdims', 1)))


def ArgMin_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.argmin(x, dim=int(attr(op, 'axis', 0)),
                        keepdim=bool(attr(op, 'keepdims', 1)))


def CaffeArgMax_forward(op, values, ctx=None):
    x = _arg(op, values, 0, ctx, _device(values))
    return torch.argmax(x, dim=int(attr(op, 'axis', 1)))


# =========================================================== SOI / host ops ===
# (JAX: default.py:834-856)


def Shape_forward(op, values, ctx=None):
    start = int(attr(op, 'start', 0))
    end = attr(op, 'end')
    shape = list(values[0].shape)[start: None if end is None else int(end)]
    return np.asarray(shape, np.int64)


def Size_forward(op, values, ctx=None):
    return np.asarray(int(np.prod(values[0].shape)), np.int64)


def ConstantOfShape_forward(op, values, ctx=None):
    shape = [int(v) for v in _host(op, values[0]).reshape(-1)]
    value = np.asarray(attr(op, 'value', np.zeros(1, np.float32)))
    return np.full(shape, value.reshape(-1)[0], dtype=value.dtype)


def Range_forward(op, values, ctx=None):
    start, limit, delta = (_host(op, v).reshape(-1)[0] for v in values[:3])
    return np.arange(start, limit, delta)


def Constant_forward(op, values, ctx=None):
    return np.asarray(attr(op, 'value'))


def Parameter_forward(op, values, ctx=None):
    return np.asarray(attr(op, 'value'))


# ======================================== data-dependent and detection ops ===
# (JAX: default.py:859-993)


def NonZero_forward(op, values, ctx=None):
    """The indices of the nonzero elements, (rank, count): the count is the
    data's, so the value is read back to the host."""
    return np.stack(np.nonzero(_readback(values[0]))).astype(np.int64)


def TopK_forward(op, values, ctx=None):
    """The k largest (or smallest) along `axis`, sorted, ties toward the
    lower index (jax.lax.top_k's order): a stable sort, whose indices stay
    on the device (the JAX package hands them to the host)."""
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    k = int(_host(op, values[1]).reshape(-1)[0])
    axis = int(attr(op, 'axis', -1))
    largest = bool(int(attr(op, 'largest', 1)))
    vals, idx = torch.sort(x.movedim(axis, -1), dim=-1, descending=largest,
                           stable=True)
    return vals[..., :k].movedim(-1, axis), idx[..., :k].movedim(-1, axis)


def NonMaxSuppression_forward(op, values, ctx=None):
    """Host-side NMS (SOI output — index selection, cf. reference
    default.py:1522). boxes [nb, ns, 4], scores [nb, nc, ns]; the boxes and
    scores are read back (the number of boxes kept is the data's). The JAX
    package's loop: with no `max_output_boxes_per_class` it keeps one box a
    class."""
    boxes = _readback(values[0])
    scores = _readback(values[1])
    max_out = int(_host(op, values[2]).reshape(-1)[0]) \
        if _present(values, 2) else 0
    iou_thr = float(_host(op, values[3]).reshape(-1)[0]) \
        if _present(values, 3) else 0.0
    score_thr = float(_host(op, values[4]).reshape(-1)[0]) \
        if _present(values, 4) else -np.inf
    center = int(attr(op, 'center_point_box', 0))
    selected = []
    for b in range(boxes.shape[0]):
        for c in range(scores.shape[1]):
            s = scores[b, c]
            order = np.argsort(-s)
            order = order[s[order] > score_thr]
            keep = []
            bb = boxes[b]
            if center:
                cx, cy, w, h = bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]
                bb = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], 1)
            for i in order:
                ok = True
                for j in keep:
                    if _iou(bb[i], bb[j]) > iou_thr:
                        ok = False
                        break
                if ok:
                    keep.append(i)
                    if len(keep) >= max_out:
                        break
            selected.extend([b, c, int(i)] for i in keep)
    return np.asarray(selected, np.int64).reshape(-1, 3)


def _iou(a, b):
    y1, x1 = max(a[0], b[0]), max(a[1], b[1])
    y2, x2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, y2 - y1) * max(0.0, x2 - x1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def _bilinear_sample(img, ys, xs):
    """(JAX: default.py:941-956 `_bilinear_sample`, over a batch of ROIs.)
    img [R, C, H, W], ys [R, ny], xs [R, nx] -> [R, C, ny, nx]."""
    _, _, h, w = img.shape
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys, 0, h - 1) - y0
    wx = torch.clamp(xs, 0, w - 1) - x0
    r = torch.arange(img.shape[0], device=img.device)[:, None, None]

    def at(yi, xi):
        return img[r, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    wy = wy[:, None, :, None]
    wx = wx[:, None, None, :]
    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def RoiAlign_forward(op, values, ctx=None):
    """Bilinear ROI align (reference default.py:2417): each ROI sampled on a
    linspace grid of (output * sampling_ratio) points a side, then averaged
    over each ratio x ratio cell; every ROI at once, on the device."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    rois = _arg(op, values, 1, ctx, dev).to(torch.float32)
    batch_idx = (_indices(op, values, 2, ctx, dev) if _present(values, 2)
                 else torch.zeros(rois.shape[0], dtype=torch.int64,
                                  device=dev))
    oh = int(attr(op, 'output_height', 1))
    ow = int(attr(op, 'output_width', 1))
    ratio = int(attr(op, 'sampling_ratio', 0)) or 2
    scale = float(attr(op, 'spatial_scale', 1.0))
    x1, y1, x2, y2 = (rois * scale).unbind(1)
    ys = _linspace(y1, y2, oh * ratio)
    xs = _linspace(x1, x2, ow * ratio)
    feat = _bilinear_sample(torch.index_select(x, 0, batch_idx), ys, xs)
    feat = feat.reshape(rois.shape[0], x.shape[1], oh, ratio, ow, ratio)
    return _mean(feat, (3, 5))


def GridSample_forward(op, values, ctx=None):
    """(reference default.py:2629) — bilinear, align_corners handling,
    zeros outside; every batch element at once."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    grid = _arg(op, values, 1, ctx, dev)
    align = int(attr(op, 'align_corners', 0))
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    two = _full(2.0, gx)
    if align:
        ix = (gx + 1) * (w - 1) / two
        iy = (gy + 1) * (h - 1) / two
    else:
        ix = ((gx + 1) * w - 1) / two
        iy = ((gy + 1) * h - 1) / two
    x0 = torch.floor(ix).to(torch.int64)
    y0 = torch.floor(iy).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = ix - x0, iy - y0
    b = torch.arange(n, device=dev)[:, None, None]

    def gather(xi, yi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(x.dtype)
        xi = torch.clamp(xi, 0, w - 1)
        yi = torch.clamp(yi, 0, h - 1)
        g = x[b, :, yi, xi].permute(0, 3, 1, 2)      # [n, c, Ho, Wo]
        return g * valid[:, None]

    wx, wy = wx[:, None], wy[:, None]
    return (gather(x0, y0) * (1 - wx) * (1 - wy) + gather(x1, y0) * wx * (1 - wy)
            + gather(x0, y1) * (1 - wx) * wy + gather(x1, y1) * wx * wy)


# =============================================================== recurrent ===
# (JAX: default.py:1022-1154; lax.scan there, a loop over time here)


def _hardsigmoid(v):
    return torch.clamp(0.2 * v + 0.5, 0.0, 1.0)


def _elu(v):
    return torch.where(v > 0, v, torch.expm1(torch.where(v > 0,
                                                         torch.zeros_like(v),
                                                         v)))


_LSTM_ACTS = {
    'sigmoid': _sigmoid, 'tanh': torch.tanh, 'relu': torch.relu,
    'softsign': lambda v: v / (torch.abs(v) + 1), 'softplus': _softplus,
    'hardsigmoid': _hardsigmoid, 'elu': _elu,
    'leakyrelu': lambda v: torch.where(v > 0, v, 0.01 * v),
}


def _optional(op, values, idx, ctx, dev, shape, like):
    if _present(values, idx):
        return _arg(op, values, idx, ctx, dev)
    return torch.zeros(shape, dtype=like.dtype, device=dev)


def LSTM_forward(op, values, ctx=None):
    """ONNX LSTM (reference default.py:2951). Supports forward/bidirectional,
    iofc gate order, optional bias/initial states, `sequence_lens` (per-
    sample masking: states freeze and outputs zero past each length; the
    reverse direction reverses only the valid prefix), the `activations`
    attribute (per-direction [f, g, h] names) and `clip`. A loop over time:
    the input projection of every step in one product, then per step the
    recurrent product and the gates."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)                # [T, N, I]
    w = _arg(op, values, 1, ctx, dev)                # [D, 4H, I]
    r = _arg(op, values, 2, ctx, dev)                # [D, 4H, H]
    num_dir = w.shape[0]
    hidden = r.shape[-1]
    T, N = x.shape[0], x.shape[1]
    b = _optional(op, values, 3, ctx, dev, (num_dir, 8 * hidden), x)
    seq_lens = (_indices(op, values, 4, ctx, dev) if _present(values, 4)
                else None)
    h0 = _optional(op, values, 5, ctx, dev, (num_dir, N, hidden), x)
    c0 = _optional(op, values, 6, ctx, dev, (num_dir, N, hidden), x)
    clip = attr(op, 'clip')
    act_names = [str(_text(a)).lower() for a in (attr(op, 'activations') or [])]
    if not act_names:
        act_names = ['sigmoid', 'tanh', 'tanh'] * num_dir

    def _reverse_valid(xd):
        """Reverse each sample's VALID prefix ([seq_len-1 … 0]), leaving
        padding in place (ONNX reverse-direction semantics)."""
        if seq_lens is None:
            return torch.flip(xd, [0])
        t_ids = torch.arange(T, device=dev)[:, None]          # (T, 1)
        src = seq_lens[None, :] - 1 - t_ids                   # (T, N)
        src = torch.where(src >= 0, src, t_ids)               # pad keeps slot
        return torch.gather(xd, 0, src[:, :, None].expand(xd.shape))

    def run_dir(xd, wd, rd, bd, h, c, d):
        wb, rb = bd[:4 * hidden], bd[4 * hidden:]
        f_act, g_act, h_act = (_LSTM_ACTS[n] for n in act_names[3 * d: 3 * d + 3])
        xw = torch.matmul(xd, wd.T) + wb                      # [T, N, 4H]
        hs = []
        for t in range(T):
            gates = xw[t] + (torch.matmul(h, rd.T) + rb)
            if clip is not None:
                gates = torch.clamp(gates, -float(clip), float(clip))
            i, o, f, g = torch.split(gates, hidden, dim=-1)
            i, o, f = f_act(i), f_act(o), f_act(f)
            g = g_act(g)
            c_new = f * c + i * g
            h_new = o * h_act(c_new)
            if seq_lens is not None:
                valid = (t < seq_lens)[:, None]               # (N, 1)
                h_new = torch.where(valid, h_new, h)
                c_new = torch.where(valid, c_new, c)
                hs.append(torch.where(valid, h_new,
                                      torch.zeros_like(h_new)))
            else:
                hs.append(h_new)
            h, c = h_new, c_new
        return torch.stack(hs), h, c

    outs, hTs, cTs = [], [], []
    for d in range(num_dir):
        xd = x if d == 0 else _reverse_valid(x)
        hs, hT, cT = run_dir(xd, w[d], r[d], b[d], h0[d], c0[d], d)
        if d == 1:
            hs = _reverse_valid(hs)
        outs.append(hs)
        hTs.append(hT)
        cTs.append(cT)
    y = torch.stack(outs, dim=1)                     # [T, D, N, H]
    return y, torch.stack(hTs), torch.stack(cTs)


def GRU_forward(op, values, ctx=None):
    """ONNX GRU (reference default.py:2737), zrh gate order,
    linear_before_reset honored; as in the JAX package, `sequence_lens` and
    `activations` are not read and the reverse direction flips the whole
    sequence."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    w = _arg(op, values, 1, ctx, dev)
    r = _arg(op, values, 2, ctx, dev)
    num_dir = w.shape[0]
    hidden = r.shape[-1]
    N = x.shape[1]
    b = _optional(op, values, 3, ctx, dev, (num_dir, 6 * hidden), x)
    h0 = _optional(op, values, 5, ctx, dev, (num_dir, N, hidden), x)
    lbr = int(attr(op, 'linear_before_reset', 0))

    def run_dir(xd, wd, rd, bd, h):
        wb, rb = bd[:3 * hidden], bd[3 * hidden:]
        rz, rr, rh = torch.split(rd, hidden, dim=0)
        wbz, wbr, wbh = torch.split(wb, hidden)
        rbz, rbr, rbh = torch.split(rb, hidden)
        xz, xr, xh = torch.split(torch.matmul(xd, wd.T), hidden, dim=-1)
        hs = []
        for t in range(xd.shape[0]):
            z = _sigmoid(xz[t] + wbz + torch.matmul(h, rz.T) + rbz)
            rr_g = _sigmoid(xr[t] + wbr + torch.matmul(h, rr.T) + rbr)
            if lbr:
                hh = torch.tanh(xh[t] + wbh
                                + rr_g * (torch.matmul(h, rh.T) + rbh))
            else:
                hh = torch.tanh(xh[t] + wbh + torch.matmul(rr_g * h, rh.T)
                                + rbh)
            h = (1 - z) * hh + z * h
            hs.append(h)
        return torch.stack(hs), h

    outs, hTs = [], []
    for d in range(num_dir):
        xd = x if d == 0 else torch.flip(x, [0])
        hs, hT = run_dir(xd, w[d], r[d], b[d], h0[d])
        if d == 1:
            hs = torch.flip(hs, [0])
        outs.append(hs)
        hTs.append(hT)
    return torch.stack(outs, dim=1), torch.stack(hTs)


# =============================================================== attention ===
# (JAX: default.py:1160-1219; composed as there: product, scale, mask,
# softmax, product — not a fused attention kernel, whose arithmetic differs)


def Attention_forward(op, values, ctx=None):
    """Two layouts:
    * com.microsoft Attention (reference default.py:90): fused QKV
      projection + MHA — inputs x, qkv_weight, qkv_bias, [mask];
    * fuse_selfattention product (IR/morph.py fuse_selfattention): raw
      softmax(q @ k_t * scale) @ v over already-shaped head tensors —
      marked by the 'scale' attribute and absence of num_heads.
    """
    dev = _device(values)
    if attr(op, 'num_heads') is None:
        q, k_t, v = (_arg(op, values, i, ctx, dev) for i in range(3))
        scale = float(attr(op, 'scale', 1.0))
        probs = torch.softmax(torch.matmul(q, k_t) * scale, dim=-1)
        return torch.matmul(probs, v)
    x, w, b = (_arg(op, values, i, ctx, dev) for i in range(3))
    qkv = torch.matmul(x, w) + b                      # [N, T, 3H]
    q, k, v = torch.split(qkv, qkv.shape[-1] // 3, dim=-1)
    mask = _arg(op, values, 3, ctx, dev) if _present(values, 3) else None
    return _mha_core(q, k, v, int(attr(op, 'num_heads')), mask)


def MultiHeadAttention_forward(op, values, ctx=None):
    """(reference default.py:586) two layouts:
    * 3-4 inputs: q, k, v already projected (+ optional mask);
    * 7/11 inputs: q, k, v + projection weights wq wk wv wo
      (+ biases bq bk bv bo) — the torch MultiheadAttention export layout.
    """
    dev = _device(values)
    num_heads = int(attr(op, 'num_heads', 1))
    if len(values) >= 7:
        xq, xk, xv, wq, wk, wv, wo = (_arg(op, values, i, ctx, dev)
                                      for i in range(7))

        def bias(y, i):
            return y + _arg(op, values, i, ctx, dev) if _present(values, i) \
                else y + 0.0
        q = bias(torch.matmul(xq, wq), 7)
        k = bias(torch.matmul(xk, wk), 8)
        v = bias(torch.matmul(xv, wv), 9)
        return bias(torch.matmul(_mha_core(q, k, v, num_heads), wo), 10)
    q, k, v = (_arg(op, values, i, ctx, dev) for i in range(3))
    mask = _arg(op, values, 3, ctx, dev) if _present(values, 3) else None
    return _mha_core(q, k, v, num_heads, mask)


def _mha_core(q, k, v, num_heads, mask=None):
    n, t, h = q.shape
    hd = h // num_heads

    def split(x):
        return x.reshape(n, -1, num_heads, hd).permute(0, 2, 1, 3)

    qh, kh, vh = split(q), split(k), split(v)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / \
        _full(float(np.float32(np.sqrt(hd))), q)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :].to(torch.bool), scores,
                             _full(-1e9, scores))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vh)
    return out.permute(0, 2, 1, 3).reshape(n, t, h)


# ============================================================ misc / control ===


def Dropout_forward(op, values, ctx=None):
    """Identity at inference (JAX: default.py:1225-1226)."""
    return _arg(op, values, 0, ctx, _device(values[:1]))


def Scale_forward(op, values, ctx=None):
    """Caffe Scale: y = x * scale (+ bias), channel-broadcast (JAX:
    default.py:1349-1363)."""
    dev = _device(values)
    x = _arg(op, values, 0, ctx, dev)
    scale = _arg(op, values, 1, ctx, dev)
    shape = [1] * x.ndim
    if scale.ndim == 1 and x.ndim > 1:
        shape[1] = -1
        scale = scale.reshape(shape)
    y = x * scale
    if _present(values, 2):
        bias = _arg(op, values, 2, ctx, dev)
        if bias.ndim == 1 and x.ndim > 1:
            bias = bias.reshape(shape)
        y = y + bias
    return y


def AdaptiveAvgPool2d_forward(op, values, ctx=None):
    """torch export alias (JAX: default.py:1318-1338): average-pool to a
    fixed output size; bins of the JAX package's edges where the size does
    not divide."""
    x = _arg(op, values, 0, ctx, _device(values[:1]))
    size = attr(op, 'output_size', None)
    if size is None:
        size = _host(op, values[1]) if _present(values, 1) else [1, 1]
    out_h, out_w = [int(v) for v in np.atleast_1d(size)][:2]
    n, c, h, w = x.shape
    if (h % out_h == 0) and (w % out_w == 0):
        kh, kw = h // out_h, w // out_w
        return _mean(x.reshape(n, c, out_h, kh, out_w, kw), (3, 5))
    ys = [slice((i * h) // out_h, max(((i + 1) * h + out_h - 1) // out_h,
                                      (i * h) // out_h + 1))
          for i in range(out_h)]
    xs = [slice((j * w) // out_w, max(((j + 1) * w + out_w - 1) // out_w,
                                      (j * w) // out_w + 1))
          for j in range(out_w)]
    rows = [torch.stack([_mean(x[:, :, sy, sx], (2, 3)) for sx in xs], dim=-1)
            for sy in ys]
    return torch.stack(rows, dim=-2)


# ============================================================ QDQ dialect ===


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
    x = _arg(op, values, 0, ctx, _device(values), torch.float32)
    scale = _arg(op, values, 1, ctx, x.device, torch.float32)
    zp = (_arg(op, values, 2, ctx, x.device, torch.float32)
          if _present(values, 2) else torch.zeros_like(scale))
    return quantize_linear(x, scale, zp, _qdq_axis(op, x, scale),
                           _zero_point_dtype(values))


def _dequantize_params(op, x, values, ctx, axis):
    from ...kernels.quant import _broadcast
    scale = _arg(op, values, 1, ctx, x.device, torch.float32)
    zp = (_arg(op, values, 2, ctx, x.device, torch.float32)
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
    return _arg(op, values, 0, ctx, device, torch.float32)


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
    x = _arg(op, values, 0, ctx, _device(values), torch.float32)
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
    return _arg(op, values, 0, ctx, ctx.device)


# =============================================================== the table ===
# (JAX: default.py:1390-1465, the same keys)

DEFAULT_BACKEND_TABLE = {
    'Conv': Conv_forward, 'ConvTranspose': ConvTranspose_forward,
    'MaxPool': MaxPool_forward, 'AveragePool': AveragePool_forward,
    'GlobalAveragePool': GlobalAveragePool_forward,
    'GlobalMaxPool': GlobalMaxPool_forward,
    'Gemm': Gemm_forward, 'MatMul': MatMul_forward,
    'PPQBiasFusedMatMul': PPQBiasFusedMatMul_forward,
    'Add': Add_forward, 'Sub': Sub_forward, 'Mul': Mul_forward,
    'Div': Div_forward, 'Pow': Pow_forward, 'Mod': Mod_forward,
    'Max': Max_forward, 'Min': Min_forward, 'Sum': Sum_forward,
    'Relu': Relu_forward, 'Sigmoid': Sigmoid_forward, 'Tanh': Tanh_forward,
    'Exp': Exp_forward, 'Log': Log_forward, 'Sqrt': Sqrt_forward,
    'Reciprocal': Reciprocal_forward, 'Abs': Abs_forward, 'Neg': Neg_forward,
    'Floor': Floor_forward, 'Ceil': Ceil_forward, 'Round': Round_forward,
    'Sign': Sign_forward, 'Erf': Erf_forward, 'Sin': Sin_forward,
    'Cos': Cos_forward, 'Not': Not_forward, 'Softplus': Softplus_forward,
    'Mish': Mish_forward, 'Swish': Swish_forward, 'SiLU': SiLU_forward,
    'Gelu': Gelu_forward, 'HardSwish': HardSwish_forward,
    'HardSigmoid': HardSigmoid_forward, 'Identity': Identity_forward,
    'LeakyRelu': LeakyRelu_forward, 'PRelu': PRelu_forward,
    'Clip': Clip_forward, 'Elu': Elu_forward, 'Selu': Selu_forward,
    'Equal': Equal_forward, 'Greater': Greater_forward,
    'GreaterOrEqual': GreaterOrEqual_forward, 'Less': Less_forward,
    'LessOrEqual': LessOrEqual_forward, 'And': And_forward, 'Or': Or_forward,
    'Xor': Xor_forward, 'Where': Where_forward,
    'Softmax': Softmax_forward, 'LogSoftmax': LogSoftmax_forward,
    'BatchNormalization': BatchNormalization_forward,
    'LayerNormalization': LayerNormalization_forward,
    'InstanceNormalization': InstanceNormalization_forward,
    'GroupNormalization': GroupNormalization_forward,
    'LRN': LRN_forward,
    'Reshape': Reshape_forward, 'Flatten': Flatten_forward,
    'Transpose': Transpose_forward, 'Squeeze': Squeeze_forward,
    'Unsqueeze': Unsqueeze_forward, 'Concat': Concat_forward,
    'Split': Split_forward, 'Slice': Slice_forward, 'Pad': Pad_forward,
    'Expand': Expand_forward, 'Tile': Tile_forward,
    'Gather': Gather_forward, 'GatherElements': GatherElements_forward,
    'GatherND': GatherND_forward, 'ScatterND': ScatterND_forward,
    'ScatterElements': ScatterElements_forward,
    'Cast': Cast_forward, 'Resize': Resize_forward,
    'Upsample': Upsample_forward,
    'DepthToSpace': DepthToSpace_forward, 'SpaceToDepth': SpaceToDepth_forward,
    'ReduceMean': ReduceMean_forward, 'ReduceSum': ReduceSum_forward,
    'ReduceMax': ReduceMax_forward, 'ReduceMin': ReduceMin_forward,
    'ReduceProd': ReduceProd_forward, 'ReduceL2': ReduceL2_forward,
    'ReduceL1': ReduceL1_forward, 'ReduceSumSquare': ReduceSumSquare_forward,
    'ArgMax': ArgMax_forward, 'ArgMin': ArgMin_forward,
    'Shape': Shape_forward, 'Size': Size_forward,
    'ConstantOfShape': ConstantOfShape_forward, 'Range': Range_forward,
    'NonZero': NonZero_forward, 'TopK': TopK_forward,
    'NonMaxSuppression': NonMaxSuppression_forward,
    'RoiAlign': RoiAlign_forward, 'GridSample': GridSample_forward,
    'CumSum': CumSum_forward, 'OneHot': OneHot_forward,
    'Einsum': Einsum_forward,
    'LSTM': LSTM_forward, 'GRU': GRU_forward,
    'Attention': Attention_forward,
    'MultiHeadAttention': MultiHeadAttention_forward,
    'Dropout': Dropout_forward, 'Constant': Constant_forward,
    'PPQDeviceSwitch': PPQDeviceSwitch_forward,
    'QuantizeLinear': QuantizeLinear_forward,
    'QuantizeFloating': QuantizeFloating_forward,
    'DequantizeFloating': DequantizeFloating_forward,
    'DequantizeLinear': DequantizeLinear_forward,
    # vendor / alias ops (reference table parity)
    'AdaptiveAvgPool2d': AdaptiveAvgPool2d_forward,
    'ChannelShuffle': ChannelShuffle_forward,
    'Scale': Scale_forward,
    'Parameter': Parameter_forward,
    'skipLayerNormPlugin': SkipLayerNorm_forward,
    'CaffeArgMax': CaffeArgMax_forward,
    'LayerNorm': LayerNormalization_forward,
    'grid_sampler': GridSample_forward,
    'MMCVRoiAlign': RoiAlign_forward,
    'Interp': Resize_forward,
    'Tan': Tan_forward,
}
