"""Linear fake-quant, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ppq_tpu/kernels/quant.py: `pallas_linear_quant` (tensorwise
`_quant_fwd_t_kernel`, channelwise `_channelwise_fwd` / `_quant_fwd_c_kernel`)
and `pallas_linear_quant_bwd` (`_quant_bwd_t_kernel`, `_channelwise_bwd` /
`_quant_bwd_c_kernel`). The kernels are `ppq_tpu_torch/csrc/fake_quant.cu`
and `csrc/fake_quant_bwd.cu`; the sources say what bounds them on the card
and how the design meets that.

    y = (clip(round(x / s) + round(o), qmin, qmax) - round(o)) * s
    codes=True returns the centered integer codes  q - round(o)  instead.

    backward, with raw = x / s, q = round(raw) + round(o):
    dx = g where qmin <= q <= qmax, else 0              (clip-aware STE)
    ds = sum g * ((q - round(o)) - raw | qmin - round(o) | qmax - round(o))
    do = sum g * (0 | s)                                 (LSQ; inside | outside)

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. All compute `x / s` by IEEE division, as the
JAX package's default path (quantization/qfunction.py) does, so forward and
`dx` agree bit for bit with it and with each other; `ds` and `do` are sums
taken in another order.

A tensorwise scale and offset may be host numbers (post-training
quantization: they ride as kernel arguments) or tensors on the card (a
trainable scale: the kernel reads them there, nothing crosses to the host).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import RoundingPolicy
from ..quantization.rounding import round_tensor
from .loader import LAUNCHES, check, check_cuda_input, library, stream_of

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


def _device_scalar(value: torch.Tensor, device, what: str) -> torch.Tensor:
    """A tensorwise scale or offset that is a tensor, as one float32 on
    `device`."""
    if value.numel() != 1:
        raise ValueError(f'tensorwise fake-quant takes one {what}, got '
                         f'{value.numel()}')
    return value.detach().to(device=device, dtype=torch.float32).reshape(1)


def _channel_params(scale, offset, x: torch.Tensor, axis: int):
    """Per-channel scales and offsets as contiguous float32 vectors on x's
    device, with the channel count and the elements behind the axis."""
    channels = x.shape[axis]
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    s = _as_param(scale, x.device).detach().reshape(-1).contiguous()
    o = _as_param(offset, x.device).detach().reshape(-1).contiguous()
    if s.numel() != channels or o.numel() != channels:
        raise ValueError(
            f'channelwise fake-quant on axis {axis} of {tuple(x.shape)} '
            f'takes {channels} scales and offsets, got {s.numel()} '
            f'and {o.numel()}')
    return s, o, channels, inner


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
    check_cuda_input(x, 'linear_quant')
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    code = ROUNDING_CODES[rounding]
    lib = library('fake_quant')
    with torch.cuda.device(x.device):
        stream = stream_of(x.device)
        if channel_axis is None and isinstance(scale, torch.Tensor):
            s = _device_scalar(scale, x.device, 'scale')
            o = _device_scalar(torch.as_tensor(offset), x.device, 'offset')
            rc = lib.ppq_fake_quant_tensorwise_dev(
                x.data_ptr(), y.data_ptr(), n, s.data_ptr(), o.data_ptr(),
                float(qmin), float(qmax), code, int(codes), stream)
            check(rc, 'fake_quant_tensorwise')
            LAUNCHES['fake_quant_tensorwise'] += 1
        elif channel_axis is None:
            s = np.asarray(scale, np.float32).reshape(-1)
            o = np.round(np.asarray(offset, np.float32).reshape(-1))
            if s.size != 1 or o.size != 1:
                raise ValueError('tensorwise fake-quant takes one scale and '
                                 'one offset')
            rc = lib.ppq_fake_quant_tensorwise(
                x.data_ptr(), y.data_ptr(), n, float(s[0]), float(o[0]),
                float(qmin), float(qmax), code, int(codes), stream)
            check(rc, 'fake_quant_tensorwise')
            LAUNCHES['fake_quant_tensorwise'] += 1
        else:
            s, o, channels, inner = _channel_params(
                scale, offset, x, channel_axis % x.ndim)
            rc = lib.ppq_fake_quant_channelwise(
                x.data_ptr(), y.data_ptr(), n, s.data_ptr(), o.data_ptr(),
                channels, inner, float(qmin), float(qmax), code, int(codes),
                stream)
            check(rc, 'fake_quant_channelwise')
            LAUNCHES['fake_quant_channelwise'] += 1
    return y


# ================================================================ backward ===

def linear_quant_bwd_plain(x: torch.Tensor, g: torch.Tensor, scale, offset,
                           qmin: float, qmax: float,
                           rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                           channel_axis: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain PyTorch, on any device:
    (dx, ds, do), with ds and do scalars (tensorwise) or of shape (C,)."""
    dx, ds_elem, do_elem = linear_quant_bwd_terms(
        x, g, scale, offset, qmin, qmax, rounding, channel_axis)
    if channel_axis is None:
        return dx, ds_elem.sum(), do_elem.sum()
    axis = channel_axis % x.ndim
    dims = [i for i in range(x.ndim) if i != axis]
    if not dims:                 # a vector along its own channel axis
        return dx, ds_elem, do_elem
    return dx, ds_elem.sum(dim=dims), do_elem.sum(dim=dims)


def linear_quant_bwd_terms(x, g, scale, offset, qmin, qmax, rounding,
                           channel_axis):
    """dx and the per-element terms whose sums are ds and do."""
    s = _broadcast(_as_param(scale, x.device), x.ndim, channel_axis)
    o = torch.round(_broadcast(_as_param(offset, x.device), x.ndim,
                               channel_axis))
    raw = x / s
    q_un = round_tensor(raw, rounding) + o
    below = q_un < qmin
    above = q_un > qmax
    inside = ~(below | above)            # a NaN is inside, as in jnp.where
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = torch.where(inside, g, zero)
    q = torch.clamp(q_un, qmin, qmax)
    ds_elem = torch.where(inside, (q - o) - raw,
                          torch.where(below, qmin - o, qmax - o)) * g
    do_elem = torch.where(inside, zero, s) * g
    return dx, ds_elem, do_elem


def _blocks_for(work: int, device, per_sm: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-work // 256), sms * per_sm))


# csrc/fake_quant_bwd.cu: threads of a channelwise block, and the units
# (float4s, or floats) each thread loads before it converts any
_BWD_THREADS, _BWD_LOADS = 256, 4


class ChannelwiseBwdPlan(NamedTuple):
    """The channelwise backward's one launch: its layout (`vec` 4: runs of
    float4s, 1: runs of floats, 0: inner 1, a warp's lanes on 32 channels
    of a row), its grid (blocks of channels or of 32-channel tiles, by
    splits), and the workspace it needs (floats of partials, counters;
    none with one split)."""
    vec: int
    splits: int
    grid: Tuple[int, int]
    partial_floats: int
    counters: int


def channelwise_bwd_plan(channels: int, outer: int, inner: int,
                         aligned: bool, sms: int) -> ChannelwiseBwdPlan:
    """The launch of `ppq_fake_quant_bwd_channelwise` for x of shape
    (outer, channels, inner) in memory. Where inner is 1 a block takes 32
    channels, else one. A block's channels take every element, unless the
    blocks leave the card short of two an SM and have more than one pass
    of their threads' loads: then the rows or runs are split across as
    many blocks as fill the card, no more than there are passes. Runs are
    walked in float4s where inner is a multiple of 4 and x, g, dx are
    16-byte aligned (`aligned`)."""
    if channels < 1 or channels > 2 ** 31 - 1:
        raise ValueError(f'channelwise backward over {channels} channels: the '
                         f'grid takes 1 to 2^31 - 1')
    if inner == 1:
        vec, blocks = 0, -(-channels // 32)
        per_pass = (_BWD_THREADS // 32) * _BWD_LOADS      # rows of a pass
        passes = -(-outer // per_pass)
    else:
        vec, blocks = (4 if aligned and inner % 4 == 0 else 1), channels
        passes = -(-(outer * inner // vec) // (_BWD_THREADS * _BWD_LOADS))
    splits = max(1, min(-(-2 * sms // blocks), passes, 65535))
    if splits == 1:
        return ChannelwiseBwdPlan(vec, 1, (blocks, 1), 0, 0)
    return ChannelwiseBwdPlan(vec, splits, (blocks, splits),
                              2 * channels * splits, blocks)


# (device, stream) -> (partials, counters) of the channelwise backward's
# split launches: allocated at the first such launch on the stream, grown
# when a larger one arrives, never shrunk. Launches on one stream run one
# after another, and each leaves its counters at 0.
_bwd_workspaces: Dict[Tuple[torch.device, int],
                      Tuple[torch.Tensor, torch.Tensor]] = {}


def _bwd_workspace(device, plan: ChannelwiseBwdPlan):
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    partial, counters = _bwd_workspaces.get(key, (None, None))
    if partial is None or partial.numel() < plan.partial_floats:
        partial = torch.empty(plan.partial_floats, dtype=torch.float32,
                              device=device)
    if counters is None or counters.numel() < plan.counters:
        counters = torch.zeros(plan.counters, dtype=torch.int32,
                               device=device)
    _bwd_workspaces[key] = (partial, counters)
    return partial.data_ptr(), counters.data_ptr()


def linear_quant_bwd(x: torch.Tensor, g: torch.Tensor, scale, offset,
                     qmin: float, qmax: float,
                     rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                     channel_axis: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, ds, do) of the fake-quant at x for the output gradient g, in one
    pass over x and g. CPU tensors take the plain version; CUDA tensors the
    kernel. The same inputs give the same bits on every run."""
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f'gradient {tuple(g.shape)} on {g.device} does not '
                         f'match x {tuple(x.shape)} on {x.device}')
    if x.device.type == 'cpu':
        return linear_quant_bwd_plain(x, g, scale, offset, qmin, qmax,
                                      rounding, channel_axis)
    if x.device.type != 'cuda':
        raise ValueError(f'linear_quant_bwd runs on cpu or cuda, not {x.device}')
    check_cuda_input(x, 'linear_quant_bwd')
    check_cuda_input(g, 'linear_quant_bwd')
    dx = torch.empty_like(x)
    n = x.numel()
    code = ROUNDING_CODES[rounding]
    if channel_axis is None:
        s = _device_scalar(_as_param(scale, x.device), x.device, 'scale')
        o = _device_scalar(_as_param(offset, x.device), x.device, 'offset')
        if n == 0:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            return dx, zero, zero.clone()
        blocks = _blocks_for(-(-n // 4), x.device, per_sm=8)
        partial = torch.empty(2 * blocks, dtype=torch.float32, device=x.device)
        out = torch.empty(2, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            rc = library('fake_quant_bwd').ppq_fake_quant_bwd_tensorwise(
                x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, s.data_ptr(),
                o.data_ptr(), float(qmin), float(qmax), code,
                partial.data_ptr(), blocks, out.data_ptr(),
                out.data_ptr() + 4, stream_of(x.device))
        check(rc, 'fake_quant_bwd_tensorwise')
        LAUNCHES['fake_quant_bwd_tensorwise'] += 1
        return dx, out[0], out[1]
    s, o, channels, inner = _channel_params(scale, offset, x,
                                            channel_axis % x.ndim)
    if n == 0:
        zero = torch.zeros(channels, dtype=torch.float32, device=x.device)
        return dx, zero, zero.clone()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, dx))
    plan = channelwise_bwd_plan(
        channels, n // (channels * inner), inner, aligned,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty(2, channels, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        partial, counters = (_bwd_workspace(x.device, plan)
                             if plan.splits > 1 else (None, None))
        rc = library('fake_quant_bwd').ppq_fake_quant_bwd_channelwise(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, s.data_ptr(),
            o.data_ptr(), channels, inner, float(qmin), float(qmax), code,
            plan.vec, plan.splits, partial, counters, out.data_ptr(),
            out.data_ptr() + 4 * channels, stream_of(x.device))
    check(rc, 'fake_quant_bwd_channelwise')
    LAUNCHES['fake_quant_bwd_channelwise'] += 1
    return dx, out[0], out[1]
