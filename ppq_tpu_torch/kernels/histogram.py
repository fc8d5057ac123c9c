"""Calibration histogram: the CUDA kernel's wrapper and its plain version.

Counterpart of ppq_tpu/kernels/histogram.py `pallas_histogram`
(`_hist_kernel`). The kernel is `ppq_tpu_torch/csrc/histogram.cu`; its
source says what bounds it on the card and how the design meets that.

    counts[b] += #{ i : clip(int(v_i / scale), 0, bins - 1) == b }
    v = |x| (absolute) or x (signed: negative values fall in bin 0)

Counts are exact int64 and are added into `out`, the caller's running
counts, so calibration folds its batches on the device without a float
round trip (the JAX kernel's f32 counts stop being exact above 2^24).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .loader import LAUNCHES, check, library, stream_of

# shared memory a block may use without opting in: 48 KB of int32 bins
MAX_BINS = 12288


def histogram_plain(x: torch.Tensor, scale: float, bins: int,
                    absolute: bool = True,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, on any device. Clamping the
    quotient before the cast gives the same bin as a saturating truncation
    followed by the clip; a NaN goes to bin 0, as XLA's convert sends it."""
    v = x.reshape(-1)
    if absolute:
        v = torch.abs(v)
    s = torch.as_tensor(np.float32(scale), device=x.device)
    q = torch.nan_to_num(v / s, nan=0.0)
    idx = torch.clamp(q, 0, bins - 1).to(torch.int64)
    counts = torch.bincount(idx, minlength=bins)
    if out is None:
        return counts
    out += counts
    return out


def histogram(x: torch.Tensor, scale: float, bins: int,
              absolute: bool = True,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bin counts of x (int64, shape (bins,)), added into `out` when given.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if out is not None and (out.dtype != torch.int64 or out.shape != (bins,)
                            or out.device != x.device):
        raise ValueError(f'out must be int64 of shape ({bins},) on {x.device}')
    if x.device.type == 'cpu':
        return histogram_plain(x, scale, bins, absolute, out)
    if x.device.type != 'cuda':
        raise ValueError(f'histogram runs on cpu or cuda, not {x.device}')
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError('histogram takes a contiguous float32 tensor')
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f'histogram takes 1..{MAX_BINS} bins, got {bins}')
    if out is None:
        out = torch.zeros(bins, dtype=torch.int64, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    lib = library('histogram')
    with torch.cuda.device(x.device):
        stream = stream_of(x.device)
        rc = lib.ppq_histogram(x.data_ptr(), n, float(np.float32(scale)),
                               int(bins), int(bool(absolute)), out.data_ptr(),
                               stream)
    check(rc, 'histogram')
    LAUNCHES['histogram'] += 1
    return out
