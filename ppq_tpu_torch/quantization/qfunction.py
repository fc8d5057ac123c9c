"""Fake-quantization functions — the numerical heart of the framework.

Port of ppq_tpu/quantization/qfunction.py to PyTorch:

  * `linear_fake_quant`   — y = (clip(round(x/s) + o, qmin, qmax) - o) * s,
    per-tensor or per-channel, 7 rounding policies. On a CUDA tensor it
    launches the hand-written kernel (kernels/quant.py), on a CPU tensor it
    runs the kernel's plain version. Where a gradient is recorded it is a
    `torch.autograd.Function`: clip-aware STE for x and LSQ gradients for
    scale and offset, from the backward kernel in one pass.
  * `linear_quant_codes` / `linear_recover_codes` — the centered integer
    codes of the same map, from a raw or an already fake-quantized value.
  * `dynamic_linear_fake_quant` — scale taken from the tensor at run time.
  * `floating_fake_quant` — FP8-style exponent/mantissa quantization through
    the kernels of kernels/floating.py; the gradient is the kernel's STE.
  * `ppq_fake_quant(x, cfg)` — TQC-driven dispatch (qfunction/__init__.py:10),
    reading the scale and offset from `device_qparams`: uploaded once per
    root TQC and device, not at every call. A copy from pageable host memory
    could not be captured into a CUDA graph (executor/compile.py).
  * `ppq_quant_toint(value, cfg)` — real integer output for exporters
    (qfunction/linear.py:218), host-side numpy.
  * `fake_quant_np` — host-side fake quant used by ParameterBakingPass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import RoundingPolicy, TensorQuantizationConfig
from ..kernels.floating import (float_max, floating_quant,
                                floating_quant_bwd)
from ..kernels.quant import (_as_param, _broadcast, linear_quant,
                             linear_quant_bwd)

# ========================================================== linear quant ===


def _needs_grad(*values) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


class _LinearFakeQuant(torch.autograd.Function):
    """Forward: the fake-quant kernel. Backward: the LSQ kernel, which
    gives dx, dscale and doffset from one pass over x and the gradient
    (ppq_tpu/quantization/qfunction.py `_linear_quant_bwd`)."""

    @staticmethod
    def forward(ctx, x, scale, offset, qmin, qmax, rounding, channel_axis):
        ctx.save_for_backward(x, scale, offset)
        ctx.args = (qmin, qmax, rounding, channel_axis)
        return linear_quant(x, scale, offset, qmin, qmax, rounding,
                            channel_axis)

    @staticmethod
    def backward(ctx, gy):
        x, scale, offset = ctx.saved_tensors
        qmin, qmax, rounding, channel_axis = ctx.args
        dx, ds, do = linear_quant_bwd(x, gy.contiguous(), scale, offset,
                                      qmin, qmax, rounding, channel_axis)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                ds.reshape(scale.shape) if need[1] else None,
                do.reshape(offset.shape) if need[2] else None,
                None, None, None, None)


def linear_fake_quant(x: torch.Tensor, scale, offset,
                      quant_min: float, quant_max: float,
                      rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                      channel_axis: Optional[int] = None) -> torch.Tensor:
    """Linear fake-quant (tensorwise or channelwise), differentiable in x,
    scale and offset. Where no gradient is recorded it is one kernel launch
    and saves nothing."""
    if not _needs_grad(x, scale, offset):
        return linear_quant(x, scale, offset, float(quant_min),
                            float(quant_max), rounding, channel_axis)
    return _LinearFakeQuant.apply(
        x, _as_param(scale, x.device), _as_param(offset, x.device),
        float(quant_min), float(quant_max), rounding, channel_axis)


def linear_quant_codes(x: torch.Tensor, scale, offset,
                       quant_min: float, quant_max: float,
                       rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                       channel_axis: Optional[int] = None) -> torch.Tensor:
    """Centered integer codes of linear quantization: q - round(o), where
    q = clip(round(x/s) + round(o), qmin, qmax). Identity:
    fake_quant(x) == codes * s."""
    return linear_quant(x, scale, offset, float(quant_min), float(quant_max),
                        rounding, channel_axis, codes=True)


def linear_recover_codes(x_fq: torch.Tensor, scale, offset, quant_min: float,
                         quant_max: float,
                         channel_axis: Optional[int] = None) -> torch.Tensor:
    """Recover centered integer codes from an ALREADY fake-quantized value
    (x_fq == codes * s exactly, up to one fp32 rounding): round(x_fq / s),
    clipped to the code range."""
    s = _broadcast(_as_param(scale, x_fq.device), x_fq.ndim, channel_axis)
    o_r = torch.round(_broadcast(_as_param(offset, x_fq.device), x_fq.ndim,
                                 channel_axis))
    codes = torch.round(x_fq / s)
    return torch.minimum(torch.maximum(codes, quant_min - o_r),
                         quant_max - o_r)


def filled_scalar(value, device) -> torch.Tensor:
    """A float32 scalar made on `device` by a fill kernel: an upload from
    the host could not be captured into a CUDA graph."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def dynamic_linear_fake_quant(x: torch.Tensor, quant_min: float,
                              quant_max: float, symmetric: bool = True,
                              rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                              channel_axis: Optional[int] = None) -> torch.Tensor:
    """Dynamic quantization: scale computed from the tensor itself at run
    time (qfunction/linear.py:99-130), on the tensor's device; the
    quantization itself goes through the fake-quant kernel."""
    if channel_axis is not None:
        axis = channel_axis % x.ndim
        dims = [i for i in range(x.ndim) if i != axis]
    else:
        dims = list(range(x.ndim))
    # divisors are tensors: CUDA PyTorch would turn a division by a host
    # number into a multiplication by its reciprocal
    floor = filled_scalar(1e-8, x.device)
    if symmetric:
        amax = torch.amax(torch.abs(x), dim=dims)
        span = filled_scalar(quant_max, x.device)
        scale = torch.maximum(amax / span, floor)
        offset = torch.zeros_like(scale)
    else:
        hi = torch.amax(x, dim=dims)
        lo = torch.amin(x, dim=dims)
        span = filled_scalar(quant_max - quant_min, x.device)
        scale = torch.maximum((hi - lo) / span, floor)
        offset = torch.round(float(quant_min) - lo / scale)
    return linear_fake_quant(x, scale, offset, quant_min, quant_max, rounding,
                             channel_axis)


# ======================================================== floating quant ===

_float_minmax = float_max


class _FloatingFakeQuant(torch.autograd.Function):
    """Forward: the floating fake-quant kernel. Backward: dx from the STE
    kernel; dscale, where asked for, by plain reductions over the saved
    tensors (the JAX package has no kernel for it either):
    sum(g * (y/s - where(inside, x/s, 0)))."""

    @staticmethod
    def forward(ctx, x, scale, e_bits, m_bits, qmin, qmax):
        y = floating_quant(x, scale, e_bits, m_bits, qmin, qmax)
        ctx.args = (qmin, qmax)
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, scale, y)
        else:
            ctx.save_for_backward(x, scale)
        return y

    @staticmethod
    def backward(ctx, gy):
        qmin, qmax = ctx.args
        x, scale = ctx.saved_tensors[:2]
        gy = gy.contiguous()
        dx = (floating_quant_bwd(x, gy, scale, qmin, qmax)
              if ctx.needs_input_grad[0] else None)
        ds = None
        if ctx.needs_input_grad[1]:
            y = ctx.saved_tensors[2]
            s = scale.reshape(())
            raw = x / s
            inside = (raw >= qmin) & (raw <= qmax)
            ds = torch.sum(gy * (y / s - torch.where(
                inside, raw, torch.zeros_like(raw)))).reshape(scale.shape)
        return dx, ds, None, None, None, None


def floating_fake_quant(x: torch.Tensor, scale, exponent_bits: int,
                        mantissa_bits: int, quant_min: float,
                        quant_max: float,
                        channel_axis: Optional[int] = None) -> torch.Tensor:
    """FP8-style fake quant: y = float_round(clip(x/s)) * s, onto the grid
    of a 1-sign / E / M float (reference: csrc/cuda/floating.cu
    QuantizeTensor_FT). The gradient is the kernel's straight-through
    estimator (ppq_tpu/kernels/floating.py `pallas_floating_quant_bwd`), for
    a tensorwise scale."""
    if not _needs_grad(x, scale):
        return floating_quant(x, scale, int(exponent_bits),
                              int(mantissa_bits), float(quant_min),
                              float(quant_max), channel_axis)
    if channel_axis is not None:
        raise NotImplementedError(
            'the gradient of floating fake-quant is tensorwise, as the '
            'backward kernel is')
    return _FloatingFakeQuant.apply(
        x, _as_param(scale, x.device), int(exponent_bits), int(mantissa_bits),
        float(quant_min), float(quant_max))


# ======================================================= TQC-driven APIs ===


def device_qparams(cfg: TensorQuantizationConfig, device):
    """(scale, offset) of cfg as float32 tensors on `device`, from its root
    TQC (the config that `dominated_by` resolves to). The pair is kept on the
    root and dropped there when its scale, offset, state or domination
    changes; cfg's symmetric policy reads a zero offset, as ppq_fake_quant
    always did. Upload happens here, at the first call for a device: a
    caller that captures a CUDA graph calls once before the capture."""
    asymmetric = cfg.policy.asymmetric
    root = cfg.dominated_by
    device = torch.device(device)
    key = (device, bool(asymmetric))
    hit = root._device_qparams.get(key)
    if hit is None:
        scale = np.asarray(root.scale, np.float32)
        offset = (np.asarray(root.offset, np.float32) if asymmetric
                  else np.zeros_like(scale))
        hit = (torch.as_tensor(scale, device=device),
               torch.as_tensor(offset, device=device))
        root._device_qparams[key] = hit
    return hit


def ppq_fake_quant(x: torch.Tensor, cfg: TensorQuantizationConfig) -> torch.Tensor:
    """Master dispatch (qfunction/__init__.py:10): apply cfg to x, honoring
    state, policy (linear/floating/dynamic) and granularity."""
    if not cfg.is_active:
        return x
    pol = cfg.policy
    axis = cfg.channel_axis if pol.per_channel else None
    if pol.dynamic:
        return dynamic_linear_fake_quant(
            x, cfg.quant_min, cfg.quant_max, symmetric=pol.symmetric,
            rounding=cfg.rounding, channel_axis=axis)
    scale, offset = device_qparams(cfg, x.device)
    if pol.linear:
        return linear_fake_quant(x, scale, offset, cfg.quant_min,
                                 cfg.quant_max, cfg.rounding,
                                 channel_axis=axis)
    mantissa_bits = cfg.num_of_bits - 1 - cfg.exponent_bits
    return floating_fake_quant(x, scale, cfg.exponent_bits, mantissa_bits,
                               cfg.quant_min, cfg.quant_max,
                               channel_axis=axis)


def ppq_quant_toint(value: np.ndarray, cfg: TensorQuantizationConfig) -> np.ndarray:
    """Produce REAL integer values for exporters (qfunction/linear.py:218).

    Returns int8 for signed 8-bit schemes, uint8 for unsigned, int32
    otherwise. Host-side numpy (exporters never run on device).
    """
    if not cfg.policy.linear:
        raise ValueError('toint only applies to linear quantization')
    value = np.asarray(value, np.float32)
    scale = np.asarray(cfg.scale, np.float32)
    offset = (np.asarray(cfg.offset, np.float32) if cfg.policy.asymmetric
              else np.zeros_like(scale))
    if cfg.policy.per_channel and cfg.channel_axis is not None:
        shape = [1] * value.ndim
        shape[cfg.channel_axis] = -1
        scale = scale.reshape(shape)
        offset = offset.reshape(shape)
    from .rounding import round_tensor_np
    q = round_tensor_np(value / scale, cfg.rounding)
    q = np.clip(q + np.round(offset), cfg.quant_min, cfg.quant_max)
    if cfg.num_of_bits <= 8:
        return q.astype(np.int8) if cfg.quant_min < 0 else q.astype(np.uint8)
    return q.astype(np.int32)


def fake_quant_np(value: np.ndarray, cfg: TensorQuantizationConfig) -> np.ndarray:
    """Host-side fake quant used by ParameterBakingPass: parameters live on
    the host, and numpy keeps the baking off the device."""
    from .rounding import round_tensor_np
    if not cfg.is_active:
        return np.asarray(value, np.float32)
    value = np.asarray(value, np.float32)
    if not cfg.policy.linear or cfg.policy.dynamic:
        # floating / dynamic: the tensor path on a CPU tensor (parameters
        # live on the host, and so does their baking)
        return ppq_fake_quant(torch.from_numpy(np.ascontiguousarray(value)),
                              cfg).numpy()
    scale = np.asarray(cfg.scale, np.float32)
    offset = (np.round(np.asarray(cfg.offset, np.float32))
              if cfg.policy.asymmetric else np.zeros_like(scale))
    if cfg.policy.per_channel and cfg.channel_axis is not None:
        shape = [1] * value.ndim
        shape[cfg.channel_axis] = -1
        scale = scale.reshape(shape)
        offset = offset.reshape(shape)
    q = round_tensor_np(value / scale, cfg.rounding) + offset
    q = np.clip(q, cfg.quant_min, cfg.quant_max)
    return ((q - offset) * scale).astype(np.float32)
