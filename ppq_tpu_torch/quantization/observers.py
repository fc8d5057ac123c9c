"""Calibration observers (redesign of ppq/quantization/observer/*).

An observer watches every batch of values flowing through one tensor during
calibration and finally renders scale/offset into its TQC. Heavy per-batch
reductions (min/max/abs-max/percentile/histogram) run on the tensor's own
device and only scalars, small vectors and the bin counts come back to the
host; the histogram goes through the hand-written kernel
(kernels/histogram.py) and its counts are folded across batches in int64 on
the device. The clip-threshold searches (KL / MSE) run host-side at render
time (they are O(bins) one-shot solves — reference does the same on CPU via
csrc/cpu/hist_mse.cc).

Observer registry mirrors OBSERVER_TABLE (observer/__init__.py:15-23):
  minmax, kl, percentile, mse, isotone, constant, floating (direct-MSE).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from ..core import (OBSERVER_KL_HIST_BINS, OBSERVER_MIN_SCALE,
                    OBSERVER_MSE_HIST_BINS, OBSERVER_PERCENTILE,
                    OBSERVER_PERCENTILE_MANUL_OVERRIDE, QuantizationStates,
                    TensorQuantizationConfig)
from ..kernels.histogram import histogram
from .rounding import round_to_power_of_2


def minmax_to_scale_offset(
        min_val: np.ndarray, max_val: np.ndarray,
        cfg: TensorQuantizationConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Convert an observed value range to (scale, offset) under cfg's policy
    (reference: observer/range.py:23-77)."""
    min_val = np.minimum(np.asarray(min_val, np.float64), 0.0)
    max_val = np.maximum(np.asarray(max_val, np.float64), 0.0)
    if cfg.policy.symmetric:
        rng = np.maximum(np.abs(min_val), np.abs(max_val))
        scale = rng / ((cfg.quant_max - cfg.quant_min) / 2.0)
        offset = np.zeros_like(scale)
    else:
        scale = (max_val - min_val) / float(cfg.quant_max - cfg.quant_min)
        offset = cfg.quant_min - min_val / np.maximum(scale, OBSERVER_MIN_SCALE)
        offset = np.clip(np.round(offset), cfg.quant_min, cfg.quant_max)
    scale = np.maximum(scale, OBSERVER_MIN_SCALE)
    if cfg.policy.power_of_2:
        scale = round_to_power_of_2(scale)
    return scale.astype(np.float32), offset.astype(np.float32)


def _as_tensor(value) -> torch.Tensor:
    """Observed values arrive as device tensors (activations) or host numpy
    arrays (parameters, observed on the CPU as the JAX package does)."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32)
    return torch.as_tensor(np.asarray(value, np.float32))


def _order_statistics(rows: torch.Tensor, lo: int, hi: int):
    """Values of ascending ranks lo <= hi along dim 1 of a (R, n) tensor, by
    a top-k from the nearer end: no sort of the whole row, and no size limit
    (torch.quantile refuses rows above 2^24 elements)."""
    n = rows.shape[1]
    if hi >= n // 2:
        k = n - lo
        top = torch.topk(rows, k, dim=1, largest=True, sorted=True).values
        return top[:, n - 1 - lo], top[:, n - 1 - hi]
    low = torch.topk(rows, hi + 1, dim=1, largest=False, sorted=True).values
    return low[:, lo], low[:, hi]


def quantile_rows_tensor(rows: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(rows, q, axis=1)` (method 'linear') of a (R, n) float32
    tensor, as a tensor on its device: the position and weights are computed
    in float32 on the host exactly as jnp does, the interpolation in float32
    on the device. Nothing is read back, so a CUDA graph can hold it."""
    n = rows.shape[1]
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    high_w = np.float32(pos - low)
    low_w = np.float32(1) - high_w
    lo = int(np.clip(low, 0, n - 1))
    hi = int(np.clip(high, 0, n - 1))
    v_lo, v_hi = _order_statistics(rows, lo, hi)
    return v_lo * float(low_w) + v_hi * float(high_w)


def quantile_rows(rows: torch.Tensor, q: float) -> np.ndarray:
    """quantile_rows_tensor, read back to the host."""
    return quantile_rows_tensor(rows, q).cpu().numpy()


class BaseTensorObserver:
    """observe() every calibration batch, then render() once
    (observer/base.py:9)."""

    def __init__(self, cfg: TensorQuantizationConfig):
        self.cfg = cfg

    def observe(self, value) -> None:
        raise NotImplementedError

    def render_quantization_config(self) -> None:
        raise NotImplementedError

    def _reduce_axes(self, ndim: int) -> Tuple[int, ...]:
        if self.cfg.policy.per_channel and self.cfg.channel_axis is not None:
            axis = self.cfg.channel_axis % ndim
            return tuple(i for i in range(ndim) if i != axis)
        return tuple(range(ndim))

    def _activate(self, scale, offset):
        self.cfg.scale = scale
        self.cfg.offset = offset
        if self.cfg.state == QuantizationStates.INITIAL:
            self.cfg.state = QuantizationStates.ACTIVATED
        elif self.cfg.state == QuantizationStates.PASSIVE_INIT:
            self.cfg.state = QuantizationStates.PASSIVE


class MinMaxObserver(BaseTensorObserver):
    """Running min/max (observer/range.py:78)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self._min: Optional[np.ndarray] = None
        self._max: Optional[np.ndarray] = None

    def observe(self, value):
        value = _as_tensor(value)
        if value.ndim == 0:
            value = value.reshape(1)
        axes = self._reduce_axes(value.ndim)
        vmin = torch.amin(value, dim=axes).cpu().numpy().astype(np.float64)
        vmax = torch.amax(value, dim=axes).cpu().numpy().astype(np.float64)
        self._min = vmin if self._min is None else np.minimum(self._min, vmin)
        self._max = vmax if self._max is None else np.maximum(self._max, vmax)

    def render_quantization_config(self):
        if self._min is None:
            raise RuntimeError('MinMaxObserver rendered before observing data')
        scale, offset = minmax_to_scale_offset(self._min, self._max, self.cfg)
        self._activate(scale, offset)


class PercentileObserver(BaseTensorObserver):
    """Clips to the p/1-p quantiles, averaged across batches
    (observer/range.py:312)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.percentile = cfg.detail.get(
            OBSERVER_PERCENTILE_MANUL_OVERRIDE, OBSERVER_PERCENTILE)
        self._lo_sum: Optional[np.ndarray] = None
        self._hi_sum: Optional[np.ndarray] = None
        self._n = 0

    def observe(self, value):
        value = _as_tensor(value)
        if self.cfg.policy.per_channel and self.cfg.channel_axis is not None:
            axis = self.cfg.channel_axis % value.ndim
            rows = torch.movedim(value, axis, 0).reshape(value.shape[axis], -1)
            hi = quantile_rows(rows, self.percentile)
            lo = quantile_rows(rows, 1.0 - self.percentile)
        else:
            rows = value.reshape(1, -1)
            hi = quantile_rows(rows, self.percentile)[0]
            lo = quantile_rows(rows, 1.0 - self.percentile)[0]
        hi = np.asarray(hi, np.float64)
        lo = np.asarray(lo, np.float64)
        self._hi_sum = hi if self._hi_sum is None else self._hi_sum + hi
        self._lo_sum = lo if self._lo_sum is None else self._lo_sum + lo
        self._n += 1

    def render_quantization_config(self):
        if self._n == 0:
            raise RuntimeError('PercentileObserver rendered before observing data')
        scale, offset = minmax_to_scale_offset(
            self._lo_sum / self._n, self._hi_sum / self._n, self.cfg)
        self._activate(scale, offset)


class _TwoPhaseHistObserver(BaseTensorObserver):
    """Shared machinery for KL / MSE observers: phase-1 abs-max range, phase-2
    histogram fill, then a clip-threshold search at render
    (observer/range.py:140-310). Per-tensor only (reference restriction).

    Phase 1 keeps the running abs-max on the device and phase 2 adds each
    batch's counts into an int64 histogram on the device; the host reads
    each once."""

    HIST_BINS = OBSERVER_KL_HIST_BINS

    def __init__(self, cfg):
        super().__init__(cfg)
        if cfg.policy.per_channel:
            raise TypeError(
                f'{type(self).__name__} supports per-tensor quantization only '
                f'(same restriction as the reference hist observers)')
        self._absmax: Optional[torch.Tensor] = None
        self._counts: Optional[torch.Tensor] = None
        self.phase = 1
        self._hist_scale: float = 1.0

    def observe(self, value):
        value = _as_tensor(value)
        if self.phase == 1:
            amax = torch.max(torch.abs(value))
            self._absmax = amax if self._absmax is None \
                else torch.maximum(self._absmax, amax)
            return
        if self._counts is None:
            absmax = 0.0 if self._absmax is None else float(self._absmax)
            self._hist_scale = max(absmax, OBSERVER_MIN_SCALE) / self.HIST_BINS
            self._counts = torch.zeros(self.HIST_BINS, dtype=torch.int64,
                                       device=value.device)
        histogram(value.contiguous(), self._hist_scale, self.HIST_BINS,
                  absolute=True, out=self._counts)

    def start_phase2(self):
        self.phase = 2

    @property
    def _hist(self) -> Optional[np.ndarray]:
        if self._counts is None:
            return None
        return self._counts.cpu().numpy().astype(np.float64)

    def render_quantization_config(self):
        hist = self._hist
        if hist is None:
            raise RuntimeError(f'{type(self).__name__} has no histogram; run phase 2')
        clip_value = self._search(hist, self._hist_scale)
        scale, offset = minmax_to_scale_offset(
            np.asarray(-clip_value), np.asarray(clip_value), self.cfg)
        self._activate(scale, offset)

    def _search(self, hist: np.ndarray, hist_scale: float) -> float:
        raise NotImplementedError


class KLObserver(_TwoPhaseHistObserver):
    """TensorRT-style KL-divergence threshold search
    (observer/range.py:191-283)."""

    def _search(self, hist: np.ndarray, hist_scale: float) -> float:
        from .solvers import kl_threshold_search
        levels = 1 << (self.cfg.num_of_bits - 1)  # e.g. 128 for int8 sym
        best_bin = kl_threshold_search(hist, levels)
        return (best_bin + 0.5) * hist_scale


class MSEObserver(_TwoPhaseHistObserver):
    """Histogram-approximated MSE threshold search (observer/range.py:406-520,
    csrc/cpu/hist_mse.cc)."""

    HIST_BINS = OBSERVER_MSE_HIST_BINS

    def _search(self, hist: np.ndarray, hist_scale: float) -> float:
        from .solvers import mse_threshold_search
        levels = 1 << (self.cfg.num_of_bits - 1)
        best_bin = mse_threshold_search(hist, hist_scale, levels)
        return (best_bin + 0.5) * hist_scale


class IsotoneObserver(BaseTensorObserver):
    """Order-preserving calibration for softmax/sigmoid outputs
    (observer/order.py:12-103): choose scale s.t. the top-1 vs top-2 order of
    every observed sample survives quantization.

    For symmetric int8 on a [0,1]-ish tensor this amounts to requiring
    (top1 - top2) > scale/2 for observed sample pairs, i.e.
    scale < 2 * min_gap; combined with covering the max value.
    """

    def __init__(self, cfg):
        super().__init__(cfg)
        self._max = 0.0
        self._min_gap = np.inf
        self.axis = cfg.detail.get('OBSERVER_ISOTONE_AXIS', -1)

    def observe(self, value):
        value = _as_tensor(value)
        top2 = torch.sort(value, dim=self.axis).values
        n = value.shape[self.axis]
        top1v = torch.select(top2, self.axis, n - 1)
        top2v = torch.select(top2, self.axis, n - 2) if n > 1 else top1v
        gap = float(torch.min(top1v - top2v))
        self._max = max(self._max, float(torch.max(value)))
        if gap > 0:
            self._min_gap = min(self._min_gap, gap)

    def render_quantization_config(self):
        cover_scale = self._max / max(self.cfg.quant_max, 1)
        if np.isfinite(self._min_gap):
            order_scale = self._min_gap  # quant step must not merge top1/top2
            scale = min(max(cover_scale, OBSERVER_MIN_SCALE), order_scale)
        else:
            scale = max(cover_scale, OBSERVER_MIN_SCALE)
        scale = np.float32(max(scale, OBSERVER_MIN_SCALE))
        if self.cfg.policy.power_of_2:
            scale = round_to_power_of_2(scale)
        self._activate(np.asarray(scale), np.zeros_like(np.asarray(scale)))


class ConstantObserver(BaseTensorObserver):
    """scale = 1 (FP8 default, observer/floating.py:11)."""

    def observe(self, value):
        pass

    def render_quantization_config(self):
        if self.cfg.policy.per_channel:
            # need channel count; defer until first observe provides it
            raise TypeError('ConstantObserver is per-tensor only')
        self._activate(np.float32(1.0), np.float32(0.0))


def sample_stride(value: torch.Tensor) -> int:
    """DirectMSEObserver's stride: the size over 4096, as in the JAX
    package, raised to the next number coprime with the last axis, so that
    the sample reads every position of that axis."""
    step = max(1, value.numel() // 4096)
    last = value.shape[-1] if value.ndim else 1
    while math.gcd(step, last) > 1:
        step += 1
    return step


class DirectMSEObserver(BaseTensorObserver):
    """Sample-based MSE scale search for floating quant
    (observer/floating.py:51). Collects a bounded sample, then sweeps scale
    candidates minimizing fake-quant MSE. The sample stays on the device the
    values came from (the card for activations, the host for parameters), and
    the sweep runs floating fake-quant there.

    The sample is every `step`-th element (`sample_stride`). The JAX
    package's step, the size over 4096, reads only last / gcd(step, last)
    positions of the last axis: one channel of 768 in BERT-base's [32, 128,
    768] activations, eight at batch 4; the scale then fits those channels
    alone. The port takes the next step coprime with the last axis
    (ROADMAP.md queue 3, item 36)."""

    CANDIDATES = np.power(2.0, np.arange(-8, 9, dtype=np.float64))

    def __init__(self, cfg):
        super().__init__(cfg)
        self._samples: List[torch.Tensor] = []
        self._budget = 4096 * 8

    def observe(self, value):
        value = _as_tensor(value)
        flat = value.reshape(-1)
        if sum(s.numel() for s in self._samples) < self._budget:
            self._samples.append(
                flat[::sample_stride(value)][:4096].contiguous())

    def render_quantization_config(self):
        from .qfunction import floating_fake_quant
        if not self._samples:
            raise RuntimeError('DirectMSEObserver rendered before observing data')
        device = self._samples[-1].device
        sample = torch.cat([s.to(device) for s in self._samples])
        mantissa = self.cfg.num_of_bits - 1 - self.cfg.exponent_bits
        errs = []
        for cand in self.CANDIDATES:
            q = floating_fake_quant(sample, np.float32(cand),
                                    self.cfg.exponent_bits, mantissa,
                                    self.cfg.quant_min, self.cfg.quant_max)
            errs.append(torch.mean((q - sample) ** 2))
        errs = torch.stack(errs).cpu().numpy()     # one read for all 17
        best_scale, best_err = 1.0, np.inf
        for cand, err in zip(self.CANDIDATES, errs):
            if err < best_err:                     # the first best wins
                best_err, best_scale = float(err), float(cand)
        self._activate(np.float32(best_scale), np.float32(0.0))


OBSERVER_TABLE: Dict[str, Type[BaseTensorObserver]] = {
    'minmax': MinMaxObserver,
    'kl': KLObserver,
    'percentile': PercentileObserver,
    'mse': MSEObserver,
    'isotone': IsotoneObserver,
    'constant': ConstantObserver,
    'floating': DirectMSEObserver,
}


def build_observer(cfg: TensorQuantizationConfig) -> BaseTensorObserver:
    """TensorObserverFactory (observer/__init__.py:25)."""
    algo = cfg.observer_algorithm.lower()
    if algo not in OBSERVER_TABLE:
        raise KeyError(f'Unknown observer algorithm {algo!r}; '
                       f'choose from {sorted(OBSERVER_TABLE)}')
    return OBSERVER_TABLE[algo](cfg)
