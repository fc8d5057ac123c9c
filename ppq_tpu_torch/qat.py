"""Quantization-aware training layers (ppq_tpu/qat.py; redesign of
ppq/qat/core.py:1-102, QConv1d/2d/3d and QATController), as torch.nn
modules.

`QConv2d` (NCHW inputs, OIHW weights) and `QLinear` ((out, in) weights)
fake-quantize their input activation with a trainable LSQ scale
(`act_scale`, an nn.Parameter) and their weight per output channel with a
scale taken from the weight's live absmax at every call (QAT weights move
every step, so the scale tracks the range). `mode` is CALIBRATE or TRAIN:
in CALIBRATE a layer records the running absmax of its input (the `absmax`
buffer) and passes the input through unquantized; `QATController` runs the
calibration batches and seeds every `act_scale` from it.

The fake-quant sites are the port's `linear_fake_quant`: on the card the
forward launches rows 1 (activation) and 2 (weight) of the kernel table
and the backward rows 4 and 5 (the LSQ gradients of the activation scale
and of the weight scale, which flows on to the weight through the absmax,
as `jax.grad` takes it through `jnp.max`: ties share the gradient evenly).
`interop.qat_params_from_flax` / `qat_params_to_flax` carry the JAX
package's flax variables in and out.

Two departures in form, none in value: flax's 'SAME' padding is explicit
here (the TF rule, lower and right side first when the total is odd, which
PyTorch's padding='same' refuses at a stride above 1), and the JAX QConv's
extra unquantized conv, whose result it drops (ppq_tpu/qat.py:99), is not
run.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from .core import RoundingPolicy
from .quantization.qfunction import filled_scalar, linear_fake_quant

CALIBRATE = 'calibrate'
TRAIN = 'train'
_MIN_SCALE = 1e-8


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _fake_quant_act(x: torch.Tensor, scale: torch.Tensor, bits: int = 8):
    qmax = _qmax(bits)
    return linear_fake_quant(x, scale, torch.zeros_like(scale), -qmax - 1,
                             qmax, RoundingPolicy.ROUND_HALF_EVEN)


def _fake_quant_weight(w: torch.Tensor, bits: int = 8,
                       channel_axis: Optional[int] = None) -> torch.Tensor:
    """Symmetric weight fake-quant with on-the-fly scales, per channel of
    `channel_axis` (tensorwise for None); differentiable through the scale.
    The divisor and the floor are tensors: on the card PyTorch would turn a
    division by a host number into a multiplication by its reciprocal."""
    qmax = _qmax(bits)
    if channel_axis is not None:
        dims = [i for i in range(w.ndim) if i != channel_axis]
        absmax = torch.amax(torch.abs(w), dim=dims)
    else:
        absmax = torch.amax(torch.abs(w))
    scale = torch.maximum(absmax / filled_scalar(qmax, w.device),
                          filled_scalar(_MIN_SCALE, w.device))
    return linear_fake_quant(w, scale, torch.zeros_like(scale), -qmax - 1,
                             qmax, RoundingPolicy.ROUND_HALF_EVEN,
                             channel_axis)


class _QATLayer(torch.nn.Module):
    """The activation site of a QAT layer (ppq_tpu/qat.py `QATState`)."""

    def __init__(self, bits: int, mode: str):
        super().__init__()
        if mode not in (CALIBRATE, TRAIN):
            raise ValueError(f'QAT mode is {CALIBRATE!r} or {TRAIN!r}, '
                             f'not {mode!r}')
        self.bits = bits
        self.mode = mode
        self.act_scale = torch.nn.Parameter(torch.ones((), dtype=torch.float32))
        self.register_buffer('absmax', torch.zeros((), dtype=torch.float32))

    def act_quant(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == CALIBRATE:
            with torch.no_grad():
                self.absmax.copy_(torch.maximum(
                    self.absmax, torch.amax(torch.abs(x.detach()))))
            return x
        return _fake_quant_act(
            x, torch.maximum(self.act_scale,
                             filled_scalar(_MIN_SCALE, x.device)), self.bits)


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax / lax 'SAME': out = ceil(size / stride); the total padding
    split with the odd element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class QConv2d(_QATLayer):
    """Quantized 2-d convolution (reference QConv2d, qat/core.py:18-60):
    NCHW, OIHW weight fake-quantized per output channel, input activation
    fake-quantized with a trainable scale, 'SAME' or 'VALID' padding as the
    JAX package's flax QConv takes them."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 stride: Union[int, Sequence[int]] = 1,
                 padding: str = 'SAME', bits: int = 8, mode: str = TRAIN):
        super().__init__(bits, mode)
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        self.kernel_size = k
        self.stride = (stride,) * 2 if isinstance(stride, int) \
            else tuple(stride)
        if padding not in ('SAME', 'VALID'):
            raise ValueError(f"padding is 'SAME' or 'VALID', not {padding!r}")
        self.padding = padding
        self.weight = torch.nn.Parameter(
            torch.empty(out_channels, in_channels, *k))
        self.bias = torch.nn.Parameter(torch.zeros(out_channels))
        torch.nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act_quant(x)
        wq = _fake_quant_weight(self.weight, self.bits, channel_axis=0)
        if self.padding == 'SAME':
            (top, bottom), (left, right) = (
                _same_padding(x.shape[2 + i], self.kernel_size[i],
                              self.stride[i]) for i in range(2))
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, wq, self.bias, self.stride)


class QLinear(_QATLayer):
    """Quantized dense layer (the JAX package's QDense): (out, in) weight
    fake-quantized per output feature, input activation fake-quantized
    with a trainable scale."""

    def __init__(self, in_features: int, out_features: int, bits: int = 8,
                 mode: str = TRAIN):
        super().__init__(bits, mode)
        self.weight = torch.nn.Parameter(torch.empty(out_features,
                                                     in_features))
        self.bias = torch.nn.Parameter(torch.zeros(out_features))
        torch.nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act_quant(x)
        wq = _fake_quant_weight(self.weight, self.bits, channel_axis=0)
        return torch.matmul(x, wq.t()) + self.bias


def qat_layers(model: torch.nn.Module):
    """The QAT layers of a module tree, in definition order."""
    return [m for m in model.modules() if isinstance(m, _QATLayer)]


class QATController:
    """Mode management and calibration seeding (reference qat/core.py
    QATController and its ENABLE_CALIBRATION context)."""

    def __init__(self, bits: int = 8):
        self.bits = bits

    def calibrate(self, model: torch.nn.Module,
                  batches: Iterable[torch.Tensor]) -> torch.nn.Module:
        """Run `batches` through `model` with every QAT layer in CALIBRATE
        mode (recording the running absmax of its input), then seed the
        activation scales from it; each layer gets its mode back."""
        layers = qat_layers(model)
        modes = [layer.mode for layer in layers]
        for layer in layers:
            layer.mode = CALIBRATE
        try:
            with torch.no_grad():
                for batch in batches:
                    model(batch)
        finally:
            for layer, mode in zip(layers, modes):
                layer.mode = mode
        return self.seed_scales(model)

    def seed_scales(self, model: torch.nn.Module) -> torch.nn.Module:
        """act_scale = max(absmax / qmax, 1e-8) in every QAT layer."""
        qmax = _qmax(self.bits)
        with torch.no_grad():
            for layer in qat_layers(model):
                dev = layer.absmax.device
                layer.act_scale.copy_(torch.maximum(
                    layer.absmax / filled_scalar(qmax, dev),
                    filled_scalar(_MIN_SCALE, dev)))
        return model
