"""Linear fake-quant forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ppq_tpu/kernels/quant.py `pallas_linear_quant` (tensorwise
`_quant_fwd_t_kernel`, channelwise `_channelwise_fwd` / `_quant_fwd_c_kernel`).
The kernel is `ppq_tpu_torch/csrc/fake_quant.cu`; its source says what
bounds it on the card and how the design meets that.

    y = (clip(round(x / s) + round(o), qmin, qmax) - round(o)) * s
    codes=True returns the centered integer codes  q - round(o)  instead.

On a CPU tensor `linear_quant` runs `linear_quant_plain`; on a CUDA tensor
it launches the kernel or raises. Both compute `x / s` by IEEE division, as
the JAX package's default path (quantization/qfunction.py) does, so the
two agree bit for bit with it and with each other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..core import RoundingPolicy
from ..quantization.rounding import round_tensor
from .loader import LAUNCHES, check, library

# RoundingPolicy -> rounding code of csrc/fake_quant.cu
ROUNDING_CODES = {
    RoundingPolicy.ROUND_HALF_EVEN: 0,
    RoundingPolicy.ROUND_HALF_UP: 1,
    RoundingPolicy.ROUND_TO_NEAR_INT: 1,
    RoundingPolicy.ROUND_HALF_DOWN: 2,
    RoundingPolicy.ROUND_HALF_TOWARDS_ZERO: 3,
    RoundingPolicy.ROUND_HALF_FAR_FROM_ZERO: 4,
    RoundingPolicy.ROUND_UP: 5,
    RoundingPolicy.ROUND_DOWN: 6,
}


def _as_param(value, device) -> torch.Tensor:
    """A scale or offset (host array, number or tensor) as float32 on
    `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32), device=device)


def _broadcast(param: torch.Tensor, ndim: int, channel_axis: Optional[int]):
    if param.ndim == 0 or channel_axis is None:
        return param
    shape = [1] * ndim
    shape[channel_axis] = -1
    return param.reshape(shape)


def linear_quant_plain(x: torch.Tensor, scale, offset, qmin: float,
                       qmax: float,
                       rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                       channel_axis: Optional[int] = None,
                       codes: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device.

    The scale is a tensor on x's device, never a Python number: CUDA
    PyTorch turns a division by a host scalar into a multiplication by its
    reciprocal, which is not the IEEE quotient."""
    s = _broadcast(_as_param(scale, x.device), x.ndim, channel_axis)
    o = torch.round(_broadcast(_as_param(offset, x.device), x.ndim,
                               channel_axis))
    q = torch.clamp(round_tensor(x / s, rounding) + o, qmin, qmax)
    return q - o if codes else (q - o) * s


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f'{what} takes float32, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'{what} takes a contiguous tensor')


def linear_quant(x: torch.Tensor, scale, offset, qmin: float, qmax: float,
                 rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                 channel_axis: Optional[int] = None,
                 codes: bool = False) -> torch.Tensor:
    """Fake-quant (or codes) of x, tensorwise (channel_axis None) or along
    channel_axis. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if x.device.type == 'cpu':
        return linear_quant_plain(x, scale, offset, qmin, qmax, rounding,
                                  channel_axis, codes)
    if x.device.type != 'cuda':
        raise ValueError(f'linear_quant runs on cpu or cuda, not {x.device}')
    _check_cuda_input(x, 'linear_quant')
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    code = ROUNDING_CODES[rounding]
    lib = library('fake_quant')
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        if channel_axis is None:
            s = np.asarray(scale, np.float32).reshape(-1)
            o = np.round(np.asarray(offset, np.float32).reshape(-1))
            if s.size != 1 or o.size != 1:
                raise ValueError('tensorwise fake-quant takes one scale and '
                                 'one offset')
            s, o = s[0], o[0]
            rc = lib.ppq_fake_quant_tensorwise(
                x.data_ptr(), y.data_ptr(), n, float(s), float(o),
                float(qmin), float(qmax), code, int(codes), stream)
            check(rc, 'fake_quant_tensorwise')
            LAUNCHES['fake_quant_tensorwise'] += 1
        else:
            axis = channel_axis % x.ndim
            channels = x.shape[axis]
            inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
            s = _as_param(scale, x.device).reshape(-1).contiguous()
            o = torch.round(_as_param(offset, x.device).reshape(-1)).contiguous()
            if s.numel() != channels or o.numel() != channels:
                raise ValueError(
                    f'channelwise fake-quant on axis {axis} of {tuple(x.shape)} '
                    f'takes {channels} scales and offsets, got {s.numel()} '
                    f'and {o.numel()}')
            rc = lib.ppq_fake_quant_channelwise(
                x.data_ptr(), y.data_ptr(), n, s.data_ptr(), o.data_ptr(),
                channels, inner, float(qmin), float(qmax), code, int(codes),
                stream)
            check(rc, 'fake_quant_channelwise')
            LAUNCHES['fake_quant_channelwise'] += 1
    return y
