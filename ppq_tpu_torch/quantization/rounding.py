"""Rounding policy implementations (reference: ppq/utils/round.py:97-135,
ppq/core/quant.py:123-144).

All seven policies on torch tensors, their numpy twins, and exact
python-scalar versions (used by exporters and golden tests).
"""

from __future__ import annotations

import decimal
from typing import Union

import numpy as np
import torch

from ..core import RoundingPolicy


def round_tensor(x: torch.Tensor, policy: RoundingPolicy) -> torch.Tensor:
    """Round a tensor under the given policy. `torch.round` is half-to-even,
    like `jnp.round`, so every policy matches the JAX package bit for bit."""
    if policy == RoundingPolicy.ROUND_HALF_EVEN:
        return torch.round(x)
    if policy in (RoundingPolicy.ROUND_HALF_UP, RoundingPolicy.ROUND_TO_NEAR_INT):
        return torch.floor(x + 0.5)
    if policy == RoundingPolicy.ROUND_HALF_DOWN:
        return torch.ceil(x - 0.5)
    if policy == RoundingPolicy.ROUND_HALF_TOWARDS_ZERO:
        return torch.sign(x) * torch.ceil(torch.abs(x) - 0.5)
    if policy == RoundingPolicy.ROUND_HALF_FAR_FROM_ZERO:
        return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    if policy == RoundingPolicy.ROUND_UP:
        return torch.ceil(x)
    if policy == RoundingPolicy.ROUND_DOWN:
        return torch.floor(x)
    raise ValueError(f'Unknown rounding policy {policy}')


def round_tensor_np(x, policy: RoundingPolicy):
    """Numpy twin of round_tensor — host-side parameter math must not
    round-trip an accelerator."""
    if policy == RoundingPolicy.ROUND_HALF_EVEN:
        return np.round(x)
    if policy in (RoundingPolicy.ROUND_HALF_UP, RoundingPolicy.ROUND_TO_NEAR_INT):
        return np.floor(x + 0.5)
    if policy == RoundingPolicy.ROUND_HALF_DOWN:
        return np.ceil(x - 0.5)
    if policy == RoundingPolicy.ROUND_HALF_TOWARDS_ZERO:
        return np.sign(x) * np.ceil(np.abs(x) - 0.5)
    if policy == RoundingPolicy.ROUND_HALF_FAR_FROM_ZERO:
        return np.sign(x) * np.floor(np.abs(x) + 0.5)
    if policy == RoundingPolicy.ROUND_UP:
        return np.ceil(x)
    if policy == RoundingPolicy.ROUND_DOWN:
        return np.floor(x)
    raise ValueError(f'Unknown rounding policy {policy}')


def round_scalar(value: float, policy: RoundingPolicy) -> int:
    """Exact scalar rounding via decimal arithmetic — golden reference
    (mirrors reference tests/test_rounding.py strategy)."""
    d = decimal.Decimal(repr(float(value)))
    if policy == RoundingPolicy.ROUND_HALF_EVEN:
        return int(d.quantize(decimal.Decimal('1'), rounding=decimal.ROUND_HALF_EVEN))
    if policy in (RoundingPolicy.ROUND_HALF_UP, RoundingPolicy.ROUND_TO_NEAR_INT):
        return int(np.floor(float(value) + 0.5))
    if policy == RoundingPolicy.ROUND_HALF_DOWN:
        return int(np.ceil(float(value) - 0.5))
    if policy == RoundingPolicy.ROUND_HALF_TOWARDS_ZERO:
        return int(d.quantize(decimal.Decimal('1'), rounding=decimal.ROUND_HALF_DOWN))
    if policy == RoundingPolicy.ROUND_HALF_FAR_FROM_ZERO:
        return int(d.quantize(decimal.Decimal('1'), rounding=decimal.ROUND_HALF_UP))
    if policy == RoundingPolicy.ROUND_UP:
        return int(d.quantize(decimal.Decimal('1'), rounding=decimal.ROUND_CEILING))
    if policy == RoundingPolicy.ROUND_DOWN:
        return int(d.quantize(decimal.Decimal('1'), rounding=decimal.ROUND_FLOOR))
    raise ValueError(f'Unknown rounding policy {policy}')


def round_to_power_of_2(value: Union[float, np.ndarray],
                        policy: RoundingPolicy = RoundingPolicy.ROUND_UP) -> np.ndarray:
    """Snap scale(s) to the nearest power of two (ppq/utils/round.py:115)."""
    value = np.asarray(value, np.float64)
    exp = np.log2(np.maximum(value, 1e-38))
    if policy == RoundingPolicy.ROUND_UP:
        exp = np.ceil(exp)
    elif policy == RoundingPolicy.ROUND_DOWN:
        exp = np.floor(exp)
    else:
        exp = np.round(exp)
    return np.power(2.0, exp).astype(np.float32)
