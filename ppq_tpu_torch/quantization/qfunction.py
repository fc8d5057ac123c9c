"""Fake-quantization functions — the numerical heart of the framework.

Port of ppq_tpu/quantization/qfunction.py to PyTorch:

  * `linear_fake_quant`   — y = (clip(round(x/s) + o, qmin, qmax) - o) * s,
    per-tensor or per-channel, 7 rounding policies. On a CUDA tensor it
    launches the hand-written kernel (kernels/quant.py), on a CPU tensor it
    runs the kernel's plain version.
  * `linear_quant_codes`  — the centered integer codes of the same map.
  * `ppq_fake_quant(x, cfg)` — TQC-driven dispatch (qfunction/__init__.py:10)
  * `ppq_quant_toint(value, cfg)` — real integer output for exporters
    (qfunction/linear.py:218), host-side numpy.
  * `fake_quant_np` — host-side fake quant used by ParameterBakingPass.

Gradients (STE/LSQ) belong to the training slice, floating (FP8) and
dynamic fake-quant to later slices; see ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import RoundingPolicy, TensorQuantizationConfig
from ..kernels.quant import linear_quant

_FLOATING_TODO = ('floating (FP8) fake-quant is not ported yet: ROADMAP.md '
                  'queue 1, item 9 (TPU_FP8 and the other platforms)')
_DYNAMIC_TODO = ('dynamic fake-quant is not ported yet: ROADMAP.md queue 1, '
                 'item 2 (the rest of quantization/qfunction.py)')

# ========================================================== linear quant ===


def linear_fake_quant(x: torch.Tensor, scale, offset,
                      quant_min: float, quant_max: float,
                      rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                      channel_axis: Optional[int] = None) -> torch.Tensor:
    """Linear fake-quant (tensorwise or channelwise)."""
    return linear_quant(x, scale, offset, float(quant_min), float(quant_max),
                        rounding, channel_axis)


def linear_quant_codes(x: torch.Tensor, scale, offset,
                       quant_min: float, quant_max: float,
                       rounding: RoundingPolicy = RoundingPolicy.ROUND_HALF_EVEN,
                       channel_axis: Optional[int] = None) -> torch.Tensor:
    """Centered integer codes of linear quantization: q - round(o), where
    q = clip(round(x/s) + round(o), qmin, qmax). Identity:
    fake_quant(x) == codes * s."""
    return linear_quant(x, scale, offset, float(quant_min), float(quant_max),
                        rounding, channel_axis, codes=True)


def dynamic_linear_fake_quant(x, quant_min, quant_max, symmetric=True,
                              rounding=RoundingPolicy.ROUND_HALF_EVEN,
                              channel_axis=None):
    """Dynamic quantization (qfunction/linear.py:99-130): a later slice."""
    raise NotImplementedError(_DYNAMIC_TODO)


# ======================================================== floating quant ===

def floating_fake_quant(x, scale, exponent_bits, mantissa_bits, quant_min,
                        quant_max, channel_axis=None):
    """FP8-style fake quant (qfunction/floating.py): the TPU_FP8 slice."""
    raise NotImplementedError(_FLOATING_TODO)


# ======================================================= TQC-driven APIs ===


def ppq_fake_quant(x: torch.Tensor, cfg: TensorQuantizationConfig) -> torch.Tensor:
    """Master dispatch (qfunction/__init__.py:10): apply cfg to x, honoring
    state, policy (linear/floating/dynamic) and granularity."""
    if not cfg.is_active:
        return x
    pol = cfg.policy
    if pol.dynamic:
        raise NotImplementedError(_DYNAMIC_TODO)
    if not pol.linear:
        raise NotImplementedError(_FLOATING_TODO)
    axis = cfg.channel_axis if pol.per_channel else None
    scale = np.asarray(cfg.scale, np.float32)
    offset = (np.asarray(cfg.offset, np.float32) if pol.asymmetric
              else np.zeros_like(scale))
    return linear_fake_quant(x, scale, offset, cfg.quant_min, cfg.quant_max,
                             cfg.rounding, channel_axis=axis)


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
    if not cfg.policy.linear:
        raise NotImplementedError(_FLOATING_TODO)
    if cfg.policy.dynamic:
        raise NotImplementedError(_DYNAMIC_TODO)
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
