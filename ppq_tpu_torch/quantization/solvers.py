"""Clip-threshold search solvers for histogram observers.

Host-side equivalents of the reference's native solvers
(csrc/cpu/hist_mse.cc `compute_mse_loss`, observer/range.py:191-283 KL
search). As in the JAX package (ppq_tpu/quantization/solvers.py), the KL and
MSE searches run in the native library `csrc/solvers.cc` (utils/native.py)
when PPQ_TPU_CONFIG.USING_NATIVE_SOLVER is on and the library builds; the
vectorized numpy searches below are its twins and take over where it does
not build. SEARCHES counts the searches each side ran, so that a run can
show which one calibrated it.
"""

from __future__ import annotations

import numpy as np

from ..core import OBSERVER_MSE_COMPUTE_INTERVAL, PPQ_TPU_CONFIG

# clip searches run, by the side that ran them
SEARCHES = {'native': 0, 'numpy': 0}


def _native():
    if not PPQ_TPU_CONFIG.USING_NATIVE_SOLVER:
        return None
    from ..utils.native import native_solvers
    return native_solvers()


def kl_threshold_search(hist: np.ndarray, levels: int = 128,
                        search_interval: int = 8) -> int:
    """TensorRT-style KL-divergence calibration search.

    hist — histogram of |x| over uniform bins; levels — number of positive
    quant levels (128 for symmetric int8). Returns the clip bin index whose
    truncated distribution minimizes KL(P || Q_quantized).

    Near-zero suppression: the first 0.2% of bins are zeroed (one sentinel
    count kept) before the search — the reference marks this step "crucial"
    (range.py:243-245) and it is: Relu-family activations put half their
    mass at exactly zero, and without suppression the KL search collapses
    onto that spike and returns clips ~30x too small (measured on the
    reference-parity harness: relu scale 0.00116 vs reference 0.0372).
    """
    hist = hist.astype(np.float64).copy()
    zcut = int(len(hist) * 0.002)
    if zcut > 0:
        hist[:zcut] = 0
        hist[zcut] = 1.0          # exactly the reference's sentinel
    lib = _native()
    if lib is not None:
        SEARCHES['native'] += 1
        return int(lib.kl_search(hist, levels, search_interval))
    SEARCHES['numpy'] += 1
    n = len(hist)
    best_bin, best_kl = n - 1, np.inf
    eps = 1e-12
    for i in range(levels, n + 1, search_interval):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()           # clamp outliers into last bin
        p_sum = p.sum()
        if p_sum <= 0:
            continue
        # quantize the first i bins into `levels` groups
        group = (np.arange(i) * levels) // i
        q = np.zeros(i, np.float64)
        sums = np.bincount(group, weights=hist[:i], minlength=levels)
        nonzero = np.bincount(group, weights=(hist[:i] > 0).astype(np.float64),
                              minlength=levels)
        expand = np.where(hist[:i] > 0,
                          np.where(nonzero[group] > 0,
                                   sums[group] / np.maximum(nonzero[group], 1), 0.0),
                          0.0)
        q = expand
        q_sum = q.sum()
        if q_sum <= 0:
            continue
        p_n = p / p_sum
        q_n = q / q_sum
        mask = p_n > 0
        kl = np.sum(p_n[mask] * np.log((p_n[mask] + eps) / (q_n[mask] + eps)))
        if kl < best_kl:
            best_kl, best_bin = kl, i - 1
    return best_bin


def mse_threshold_search(hist: np.ndarray, hist_scale: float,
                         levels: int = 128,
                         search_interval: int = OBSERVER_MSE_COMPUTE_INTERVAL) -> int:
    """Histogram-approximated MSE clip search (csrc/cpu/hist_mse.cc port of
    semantics, not code): pick the clip bin minimizing
    sum_b hist[b] * E[(v_b - quant(v_b))^2].

    Inside the clip range, quantization error of a uniformly-distributed bin
    is ~ step^2/12; outside, values clamp to the clip point.
    """
    lib = _native()
    if lib is not None:
        SEARCHES['native'] += 1
        return int(lib.mse_search(hist.astype(np.float64), float(hist_scale),
                                  levels, search_interval))
    SEARCHES['numpy'] += 1
    n = len(hist)
    hist = hist.astype(np.float64)
    centers = (np.arange(n) + 0.5) * hist_scale
    best_bin, best_mse = n - 1, np.inf
    for i in range(levels, n + 1, search_interval):
        clip_val = (i - 0.5) * hist_scale
        step = clip_val / levels
        inside_err = (step * step) / 12.0
        mse = hist[:i].sum() * inside_err
        if i < n:
            over = centers[i:] - clip_val
            mse += np.sum(hist[i:] * over * over)
        if mse < best_mse:
            best_mse, best_bin = mse, i - 1
    return best_bin


def isotone_solve(values: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators isotonic regression (csrc/cuda/isotone.cc
    semantics): least-squares fit of a non-decreasing sequence."""
    y = values.astype(np.float64).copy()
    n = len(y)
    w = np.ones(n)
    # blocks as (value, weight) stacks
    vals, wts, sizes = [], [], []
    for i in range(n):
        vals.append(y[i]); wts.append(1.0); sizes.append(1)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v2, w2, s2 = vals.pop(), wts.pop(), sizes.pop()
            v1, w1, s1 = vals.pop(), wts.pop(), sizes.pop()
            wt = w1 + w2
            vals.append((v1 * w1 + v2 * w2) / wt)
            wts.append(wt); sizes.append(s1 + s2)
    out = np.empty(n)
    pos = 0
    for v, s in zip(vals, sizes):
        out[pos:pos + s] = v
        pos += s
    return out
