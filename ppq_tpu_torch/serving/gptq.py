"""GPTQ weight-only quantization for the serving engine: the JAX package's
`ppq_tpu/serving/gptq.py`.

GPTQ (Frantar et al., 2022) quantizes each linear's weight rows (input
channels) one after another under the layer's input second moment
H = X^T X / N: after row i is rounded, its error is carried into the rows
not yet quantized through the upper Cholesky factor of inv(H), so that the
layer's OUTPUT error is what is minimised. Per-output-channel scales come
from quantize_weight's mse search and stay fixed through the sweep, so the
result is the engine's {w_int | w_packed, scale} format (INT4 packed
split-half, as the INT4 matmul kernel reads it).

The recurrence runs row by row in float64 on the device of the inputs (the
card for a tree made there), where the JAX package runs it in numpy: the
same operations in the same order, unblocked. H's product, the inverse and
the Cholesky factor are the device's, so a code next to a rounding tie may
fall the other way (tests/test_torch_gptq.py states the share).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..kernels import qmm as _qmm
from .awq import _rows, capture_norm_inputs
from .config import LlamaConfig
from .model import F32, Params, quantize_weight

F64 = torch.float64


def gptq_quantize_linear(w, xs, bits: int, percdamp: float = 0.01,
                         scale_method: str = 'mse') -> Dict:
    """GPTQ one linear. w: (in, out); xs: (N, in) calibration inputs
    (tensors, or numpy arrays for the CPU). Computes on xs's device and
    returns the engine weight dict ({w_int | w_packed, scale}) there."""
    xs = torch.as_tensor(xs)
    device = xs.device
    w = torch.as_tensor(w).to(device=device, dtype=F64).clone()
    din = w.shape[0]
    qmax = (1 << (bits - 1)) - 1

    # fixed per-output-channel scales from the original weights
    ref = quantize_weight(w.to(F32), bits, method=scale_method,
                          device=device)
    scale = ref['scale'].to(F64)                               # (out,)

    x64 = xs.to(F64)
    H = x64.T @ x64
    H /= max(1, xs.shape[0])
    # dead inputs (H_ii = 0) cannot be compensated: pin them
    dead = torch.diagonal(H) == 0
    idx = torch.nonzero(dead).flatten()
    H[idx, idx] = 1.0
    w[dead, :] = 0.0
    diag = torch.arange(din, device=device)
    H[diag, diag] += percdamp * float(torch.mean(torch.diagonal(H)))

    # inv(H)'s UPPER Cholesky factor (the standard GPTQ recurrence):
    # L L^T = inv(H) -> U = L^T satisfies U^T U = inv(H)
    Hinv = torch.linalg.cholesky(torch.linalg.inv(H)).T.contiguous()

    q_all = torch.zeros_like(w)
    lo, hi = float(-qmax - 1), float(qmax)
    for i in range(din):
        d = Hinv[i, i]
        qi = torch.clamp(torch.round(w[i] / scale), lo, hi, out=q_all[i])
        err = (w[i] - qi * scale) / d
        if i + 1 < din:
            w[i + 1:] -= torch.outer(Hinv[i, i + 1:], err)

    q8 = q_all.to(torch.int8)
    scale32 = scale.to(F32)
    if bits == 4:
        return {'w_packed': _qmm.pack_int4_splithalf(q8), 'scale': scale32}
    return {'w_int': q8, 'scale': scale32}


def gptq_quantize_llama_params(params_fp: Params, cfg: LlamaConfig, tokens,
                               percdamp: float = 0.01,
                               max_rows: int = 1024) -> Params:
    """GPTQ a FLOAT param tree (init_llama_params quantized=False layout)
    against a (B, T) calibration token sample, on the tree's device. Every
    layer linear is quantized under ITS OWN captured input Hessian; lm_head
    uses plain mse quantization. The linears that read one input (q | k | v,
    gate | up) share their Hessian and run one recurrence over their
    concatenated columns: columns never interact in it (the error of row i
    moves each column's later rows by that column's own error), so each
    column's arithmetic is the per-linear one."""
    caps = capture_norm_inputs(params_fp, cfg, tokens, full=True)
    bits = cfg.weight_bits
    out = dict(params_fp)
    layers: List[Dict] = []
    for layer, cap in zip(params_fp['layers'], caps):
        lay = dict(layer)
        groups = (('attn', ('wq', 'wk', 'wv')), ('ctx', ('wo',)),
                  ('mlp', ('w_gate', 'w_up')), ('act', ('w_down',)))
        for key, wkeys in groups:
            wkeys = [k for k in wkeys if k in lay and 'w' in lay[k]]
            if not wkeys:
                continue
            widths = [lay[k]['w'].shape[1] for k in wkeys]
            joint = gptq_quantize_linear(
                torch.cat([lay[k]['w'].to(F32) for k in wkeys], dim=1),
                _rows(cap[key], max_rows), bits, percdamp=percdamp)
            parts = {name: torch.split(t, widths, dim=-1)
                     for name, t in joint.items()}
            for j, k in enumerate(wkeys):
                lay[k] = {name: p[j].contiguous()
                          for name, p in parts.items()}
        layers.append(lay)
    out['layers'] = layers
    if 'w' in out['lm_head']:
        w = out['lm_head']['w']
        out['lm_head'] = quantize_weight(w.to(F32), cfg.resolved_lm_head_bits,
                                         method='mse', device=w.device)
    return out
