"""The fake-quant kernels as PyTorch custom operators, so that a traced
program (torch.export: `utils/deploy.py`) keeps each fake-quant site as
one opaque node instead of the plain version's arithmetic:

  ppq_tpu_torch::linear_quant    rows 1 and 2 of the kernel table
                                 (kernels/quant.py `linear_quant`)
  ppq_tpu_torch::floating_quant  row 6, both bodies
                                 (kernels/floating.py `floating_quant`)

Each has a CUDA implementation, the wrapper's kernel launch (counted in
`LAUNCHES`), a CPU implementation, the plain version, and a fake
implementation for shapes. Neither stands in for the other. The wrappers
call the operator only for a traced tensor (`loader.traced`); an eager call
goes to the kernel or the plain version directly. Importing
`ppq_tpu_torch.kernels` registers the operators: a saved program that names
them loads after that import.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import RoundingPolicy
from .floating import floating_quant, floating_quant_plain
from .quant import linear_quant, linear_quant_plain


@torch.library.custom_op('ppq_tpu_torch::linear_quant', mutates_args=(),
                         device_types='cpu')
def linear_quant_op(x: torch.Tensor, scale: torch.Tensor,
                    offset: torch.Tensor, qmin: float, qmax: float,
                    rounding: int, channel_axis: Optional[int],
                    codes: bool) -> torch.Tensor:
    return linear_quant_plain(x, scale, offset, qmin, qmax,
                              RoundingPolicy(rounding), channel_axis, codes)


@linear_quant_op.register_kernel('cuda')
def _linear_quant_cuda(x, scale, offset, qmin, qmax, rounding, channel_axis,
                       codes):
    return linear_quant(x, scale, offset, qmin, qmax,
                        RoundingPolicy(rounding), channel_axis, codes)


@linear_quant_op.register_fake
def _linear_quant_fake(x, scale, offset, qmin, qmax, rounding, channel_axis,
                       codes):
    return torch.empty_like(x)


@torch.library.custom_op('ppq_tpu_torch::floating_quant', mutates_args=(),
                         device_types='cpu')
def floating_quant_op(x: torch.Tensor, scale: torch.Tensor,
                      exponent_bits: int, mantissa_bits: int, qmin: float,
                      qmax: float, channel_axis: Optional[int]) -> torch.Tensor:
    return floating_quant_plain(x, scale, exponent_bits, mantissa_bits, qmin,
                                qmax, channel_axis)


@floating_quant_op.register_kernel('cuda')
def _floating_quant_cuda(x, scale, exponent_bits, mantissa_bits, qmin, qmax,
                         channel_axis):
    return floating_quant(x, scale, exponent_bits, mantissa_bits, qmin, qmax,
                          channel_axis)


@floating_quant_op.register_fake
def _floating_quant_fake(x, scale, exponent_bits, mantissa_bits, qmin, qmax,
                         channel_axis):
    return torch.empty_like(x)
