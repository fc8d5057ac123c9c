"""Graph FLOP counting for MFU reporting (ppq_tpu/utils/flops.py).

Counts 2*MACs for the compute-dominant ops (Conv/ConvTranspose/Gemm/MatMul/
PPQBiasFusedMatMul) from traced variable shapes. Elementwise/reduction work
is ignored (sub-1% on CNN/transformer graphs): this is the standard
model-FLOPs-utilization numerator (MFU = model_flops/sec / peak_flops).
The peak is the card's datasheet rate, looked up by its name.
"""

from __future__ import annotations

from typing import Optional

import torch


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def op_flops(op) -> int:
    """FLOPs (2*MACs) of one op from its variables' traced shapes; 0 if
    shapes are unknown or the op is not a dense-compute type."""
    t = op.type
    try:
        if t in ('Conv', 'ConvTranspose'):
            w = op.inputs[1]
            out = op.outputs[0]
            if w.shape is None or out.shape is None:
                return 0
            if t == 'Conv':
                # w: (Cout, Cin/g, *k); out: (N, Cout, *spatial)
                macs = _prod(out.shape) * _prod(w.shape[1:])
            else:
                # w: (Cin, Cout/g, *k); macs = in_spatial * Cin * Cout/g * k
                x = op.inputs[0]
                if x.shape is None:
                    return 0
                macs = _prod(x.shape) * _prod(w.shape[1:])
            bias = 0
            if len(op.inputs) > 2 and out.shape is not None:
                bias = _prod(out.shape)
            return 2 * macs + bias
        if t in ('Gemm', 'MatMul', 'PPQBiasFusedMatMul'):
            b = op.inputs[1]
            out = op.outputs[0]
            if b.shape is None or out.shape is None:
                return 0
            k = int(b.shape[0])
            if t == 'Gemm' and int(op.attributes.get('transB', 0)):
                k = int(b.shape[-1])
            return 2 * _prod(out.shape) * k
    except (TypeError, IndexError):
        return 0
    return 0


def graph_flops(graph, inputs=None) -> int:
    """Total forward FLOPs of the graph. If variable shapes are missing and
    `inputs` is given, traces the shapes on the CPU first."""
    total = sum(op_flops(op) for op in graph.operations.values())
    if total == 0 and inputs is not None:
        from ..executor import TorchExecutor
        TorchExecutor(graph, device='cpu').tracing_operation_meta(inputs)
        total = sum(op_flops(op) for op in graph.operations.values())
    return total


# Dense peak rates of the cards, FLOP/s (NVIDIA's data sheets, without
# sparsity, at the full power limit), by the exact name the card reports,
# one rate for each math type: 'fp32' outside the tensor cores, 'tf32',
# 'bf16' (and fp16), 'fp8', 'int8'. The MFU denominator; a card set below
# its power limit reaches less. A card not listed here gets no MFU.
_CARD_PEAKS = {
    # NVIDIA H100 SXM5 80 GB
    'NVIDIA H100 80GB HBM3': {'fp32': 67e12, 'tf32': 495e12, 'bf16': 989e12,
                              'fp8': 1979e12, 'int8': 1979e12},
}

# the math type of a compiled runner's contractions, by its precision
# (executor/compile.py): 'highest' float32 with TF32 off; 'default' and
# 'int' TF32; 'bf16' bf16 tensors
PRECISION_MATH = {'highest': 'fp32', 'default': 'tf32', 'int': 'tf32',
                  'bf16': 'bf16'}


def device_peak_flops(dtype: str = 'bf16', device=None) -> Optional[float]:
    """Peak FLOP/s of the card (`device`, the current one unless named) for
    the math type `dtype`, or None for a card the table does not list and
    for the CPU."""
    if device is not None and torch.device(device).type != 'cuda':
        return None
    if not torch.cuda.is_available():
        return None
    peaks = _CARD_PEAKS.get(torch.cuda.get_device_name(device))
    return None if peaks is None else peaks[dtype]


def mfu(model_flops_per_item: int, items_per_sec: float,
        dtype: str = 'bf16', device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1] against the peak of the math type
    `dtype`, or None off a listed card."""
    peak = device_peak_flops(dtype, device)
    if peak is None or model_flops_per_item <= 0:
        return None
    return model_flops_per_item * items_per_sec / peak
