"""Low-bit floating-point (FP8-style) fake-quant, forward and STE backward:
the CUDA kernels' wrappers and their plain versions.

Counterpart of ppq_tpu/kernels/floating.py: `pallas_floating_quant`
(tensorwise `_fp_fwd_t_kernel`, channelwise `_fp_fwd_c_kernel`, both over
`_float_round_block`) and `pallas_floating_quant_bwd` (`_fp_bwd_t_kernel`).
The kernels are `ppq_tpu_torch/csrc/floating.cu`; the source says what bounds
them on the card and how the design meets that.

    y  = float_round(clip(x / s, qmin, qmax)) * s
    dx = g where qmin <= x / s <= qmax, else 0

float_round puts a value on the grid of a 1-sign / E-exponent / M-mantissa
float: a half-to-even cut of the mantissa on the float32 bit pattern, a clamp
to +-max_val, and the subnormal grid below the smallest normal.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The plain version does the bit arithmetic on
int32 views (PyTorch has no uint32 shifts): int32 addition wraps like
uint32, and the one arithmetic shift is masked to its lowest bit, so the bit
patterns are the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .loader import (LAUNCHES, check, check_cuda_input, library,
                     stream_of, traced)
from .quant import _as_param, _broadcast

_FP8_MAX = {(4, 3): 448.0, (5, 2): 57344.0}
_FLOAT32_MAX = float(np.finfo(np.float32).max)


def float_max(exponent_bits: int, mantissa_bits: int) -> float:
    """Largest representable magnitude of a 1-sign/E/M float (finite,
    e4m3fn-style: all-ones exponent is a normal number except all-ones
    mantissa)."""
    if (exponent_bits, mantissa_bits) in _FP8_MAX:
        return _FP8_MAX[(exponent_bits, mantissa_bits)]
    bias = (1 << (exponent_bits - 1)) - 1
    max_exp = (1 << exponent_bits) - 1 - bias  # IEEE-style, inf reserved
    max_mant = 2.0 - 2.0 ** (-mantissa_bits)
    return max_mant * (2.0 ** (max_exp - 1))


def _layout(exponent_bits: int, mantissa_bits: int):
    """(max_val, min_normal, min_subnormal) of the layout."""
    if not 1 <= mantissa_bits <= 22 or not 1 <= exponent_bits <= 8:
        raise ValueError(f'floating fake-quant takes 1..8 exponent and 1..22 '
                         f'mantissa bits, got E{exponent_bits}M{mantissa_bits}')
    e_bias = (1 << (exponent_bits - 1)) - 1
    min_normal = 2.0 ** (1 - e_bias)
    return (float(float_max(exponent_bits, mantissa_bits)), min_normal,
            min_normal * 2.0 ** (-mantissa_bits))


def float_round_plain(scaled: torch.Tensor, exponent_bits: int,
                      mantissa_bits: int) -> torch.Tensor:
    """Round float32 values to the E/M grid (ppq_tpu `_float_round_block`)."""
    max_val, min_normal, min_sub = _layout(exponent_bits, mantissa_bits)
    bits = scaled.contiguous().view(torch.int32)
    drop = 23 - mantissa_bits
    # in place on one fresh buffer: ((bits >> drop) & 1) + half - 1 + bits
    rounded = bits >> drop
    rounded.bitwise_and_(1).add_((1 << (drop - 1)) - 1).add_(bits)
    rounded.bitwise_and_(-(1 << drop))
    y = rounded.view(torch.float32).clamp_(-max_val, max_val)
    # min_sub is a power of 2 (the quotients are exact), and every value
    # at or above min_normal is a multiple of it: where y / min_sub stays
    # finite, rounding to the subnormal grid leaves those values as they are.
    if max_val / min_sub <= _FLOAT32_MAX:
        return y.div_(min_sub).round_().mul_(min_sub)
    sub_grid = torch.round(y / min_sub).mul_(min_sub)
    return torch.where(torch.abs(y) < min_normal, sub_grid, y)


def floating_quant_plain(x: torch.Tensor, scale, exponent_bits: int,
                         mantissa_bits: int, qmin: float, qmax: float,
                         channel_axis: Optional[int] = None) -> torch.Tensor:
    """The forward kernel's arithmetic in plain PyTorch, on any device. The
    scale is a tensor on x's device, so that `x / s` is the IEEE quotient."""
    s = _broadcast(_as_param(scale, x.device), x.ndim, channel_axis)
    scaled = (x / s).clamp_(qmin, qmax)
    return float_round_plain(scaled, exponent_bits, mantissa_bits).mul_(s)


def floating_quant_bwd_plain(x: torch.Tensor, g: torch.Tensor, scale,
                             qmin: float, qmax: float) -> torch.Tensor:
    """The backward kernel's arithmetic in plain PyTorch (tensorwise)."""
    raw = x / _as_param(scale, x.device).reshape(())
    inside = (raw >= qmin) & (raw <= qmax)           # a NaN is outside
    return torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                              device=g.device))


def _tensor_scale(scale, device):
    """A tensorwise scale as (host float, device pointer or None, keepalive)."""
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f'tensorwise floating fake-quant takes one scale, '
                             f'got {scale.numel()}')
        s = scale.detach().to(device=device, dtype=torch.float32).reshape(1)
        return 1.0, s.data_ptr(), s
    s = np.asarray(scale, np.float32).reshape(-1)
    if s.size != 1:
        raise ValueError(f'tensorwise floating fake-quant takes one scale, '
                         f'got {s.size}')
    return float(s[0]), None, None


def floating_quant(x: torch.Tensor, scale, exponent_bits: int,
                   mantissa_bits: int, qmin: float, qmax: float,
                   channel_axis: Optional[int] = None) -> torch.Tensor:
    """Floating fake-quant of x, tensorwise (channel_axis None) or along
    channel_axis. CPU tensors take the plain version; CUDA tensors the
    kernel; a traced tensor the custom operator
    `ppq_tpu_torch::floating_quant`, whose implementations are these two."""
    if traced(x):
        return torch.ops.ppq_tpu_torch.floating_quant(
            x, _as_param(scale, x.device), int(exponent_bits),
            int(mantissa_bits), float(qmin), float(qmax), channel_axis)
    if x.device.type == 'cpu':
        return floating_quant_plain(x, scale, exponent_bits, mantissa_bits,
                                    qmin, qmax, channel_axis)
    if x.device.type != 'cuda':
        raise ValueError(f'floating_quant runs on cpu or cuda, not {x.device}')
    check_cuda_input(x, 'floating_quant')
    max_val, min_normal, min_sub = _layout(exponent_bits, mantissa_bits)
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    lib = library('floating')
    with torch.cuda.device(x.device):
        if channel_axis is None:
            s_host, s_ptr, _keep = _tensor_scale(scale, x.device)
            rc = lib.ppq_floating_quant_tensorwise(
                x.data_ptr(), y.data_ptr(), n, s_host, s_ptr, float(qmin),
                float(qmax), int(mantissa_bits), max_val, min_normal, min_sub,
                stream_of(x.device))
        else:
            axis = channel_axis % x.ndim
            channels = x.shape[axis]
            inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
            s = _as_param(scale, x.device).detach().reshape(-1).contiguous()
            if s.numel() != channels:
                raise ValueError(
                    f'channelwise floating fake-quant on axis {axis} of '
                    f'{tuple(x.shape)} takes {channels} scales, got '
                    f'{s.numel()}')
            rc = lib.ppq_floating_quant_channelwise(
                x.data_ptr(), y.data_ptr(), n, s.data_ptr(), channels, inner,
                float(qmin), float(qmax), int(mantissa_bits), max_val,
                min_normal, min_sub, stream_of(x.device))
    check(rc, 'floating_quant')
    LAUNCHES['floating_quant'] += 1
    return y


def floating_quant_bwd(x: torch.Tensor, g: torch.Tensor, scale, qmin: float,
                       qmax: float) -> torch.Tensor:
    """dx of the tensorwise floating fake-quant at x for the output gradient
    g: the straight-through estimator inside the clip range. CPU tensors take
    the plain version; CUDA tensors the kernel."""
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f'gradient {tuple(g.shape)} on {g.device} does not '
                         f'match x {tuple(x.shape)} on {x.device}')
    if x.device.type == 'cpu':
        return floating_quant_bwd_plain(x, g, scale, qmin, qmax)
    if x.device.type != 'cuda':
        raise ValueError(f'floating_quant_bwd runs on cpu or cuda, not {x.device}')
    check_cuda_input(x, 'floating_quant_bwd')
    check_cuda_input(g, 'floating_quant_bwd')
    dx = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return dx
    with torch.cuda.device(x.device):
        s_host, s_ptr, _keep = _tensor_scale(scale, x.device)
        rc = library('floating').ppq_floating_quant_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, s_host, s_ptr,
            float(qmin), float(qmax), stream_of(x.device))
    check(rc, 'floating_quant_bwd')
    LAUNCHES['floating_quant_bwd'] += 1
    return dx
