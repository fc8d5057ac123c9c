"""Fused dequant-matmul for weight-only INT8 serving: the CUDA kernels'
wrappers and their plain versions.

Counterpart of ppq_tpu/kernels/qmm.py `qmm_int8` (`_qmm8_kernel`,
`_mk_qmm8_ex`) and `qmm_gateup` (INT8 body, `_qmm8_gu_kernel`). The kernels
are `ppq_tpu_torch/csrc/qmm.cu`; its source says what bounds them on the
card and how the design meets that.

    qmm_int8:   out = (x_bf16 @ w_int8, f32 sum) * scale[F]
                      [* row_scale[B]] [+ residual[B, F]]
    qmm_gateup: g = (x @ Wg) * sg [* row]; u = (x @ Wu) * su [* row]
                out = g * sigmoid(g) * u,  weight = [Wg | Wu]  (D, 2 F)

The epilogue runs in f32 in that order and the result is cast once. The
INT4 bodies (split-half packed nibbles) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .loader import LAUNCHES, check, library, stream_of

# SMs of an H100: a weight too narrow to give every SM a 64-column block
# takes 32-column blocks
_SMS = 132


def supports(d: int, f: int, b: int = 64) -> bool:
    """The shapes the kernel tiles: the JAX package's rule without its
    fast-memory budget, which has no counterpart on the card."""
    return d % 256 == 0 and f % 128 == 0 and b >= 1


def supports_gateup(d: int, f2: int, b: int, bits: int = 8) -> bool:
    """f2 = fused gate|up output width (2 * d_ff). INT8 only."""
    if f2 % 2 or bits != 8:
        return False
    return d % 256 == 0 and (f2 // 2) % 128 == 0 and b >= 1


def _row(row_scale, rows):
    return None if row_scale is None \
        else row_scale.reshape(rows, 1).to(torch.float32)


def qmm_int8_plain(x, w_int, scale, out_dtype=torch.bfloat16,
                   row_scale=None, residual=None):
    """The kernel's arithmetic in plain PyTorch, on any device: operands
    rounded to bf16, an f32 product, then scale, row scale and residual one
    by one in f32."""
    B = x.shape[0]
    acc = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                       w_int.to(torch.float32))
    acc = acc * scale.to(torch.float32).reshape(1, -1)
    if row_scale is not None:
        acc = acc * _row(row_scale, B)
    if residual is not None:
        acc = acc + residual.reshape(B, -1).to(torch.float32)
    return acc.to(out_dtype)


def qmm_gateup_plain(x, w_int, scale, out_dtype=torch.bfloat16,
                     row_scale=None):
    B = x.shape[0]
    F = w_int.shape[1] // 2
    both = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        w_int.to(torch.float32))
    both = both * scale.to(torch.float32).reshape(1, -1)
    if row_scale is not None:
        both = both * _row(row_scale, B)
    g, u = both[:, :F], both[:, F:]
    return (g * torch.sigmoid(g) * u).to(out_dtype)


def _check(x, w_int, scale, out_dtype, what):
    if x.dim() != 2 or w_int.dim() != 2 or x.shape[1] != w_int.shape[0]:
        raise ValueError(f'{what}: x {tuple(x.shape)} against w '
                         f'{tuple(w_int.shape)}')
    if w_int.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f'{what} takes an int8 weight and float32 scales')
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{what} writes float32 or bfloat16, not {out_dtype}')
    if scale.numel() != w_int.shape[1]:
        raise ValueError(f'{what}: {scale.numel()} scales for '
                         f'{w_int.shape[1]} columns')
    for t in (w_int, scale):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f'{what} takes contiguous tensors on {x.device}')


def _aligned(what, *tensors):
    """The kernels read x in 16-byte vectors and the other operands in
    pairs: a view at an odd storage offset would fault on the card."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f'{what} takes 16-byte aligned tensors')


def _narrow(f_out: int, rows: int) -> int:
    return int((f_out // 64) * -(-rows // 128) < _SMS)


def qmm_int8(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16,
             row_scale: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, D); w_int: (D, F) int8; scale: (F,) f32 -> (B, F).
    row_scale: optional (B,) or (B, 1) f32 multiplied into each output row;
    residual: optional (B, F), bf16 or f32, added after all scaling.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    _check(x, w_int, scale, out_dtype, 'qmm_int8')
    if x.device.type == 'cpu':
        return qmm_int8_plain(x, w_int, scale, out_dtype, row_scale, residual)
    if x.device.type != 'cuda':
        raise ValueError(f'qmm_int8 runs on cpu or cuda, not {x.device}')
    B, D = x.shape
    F = w_int.shape[1]
    if not supports(D, F, B):
        raise ValueError(f'qmm_int8 does not tile D={D}, F={F}')
    x = x.to(torch.bfloat16).contiguous()
    row = None
    if row_scale is not None:
        row = _row(row_scale, B).contiguous()
    res = None
    if residual is not None:
        res = residual.reshape(B, F)
        if res.dtype not in (torch.float32, torch.bfloat16):
            res = res.to(torch.float32)
        res = res.contiguous()
    out = torch.empty((B, F), dtype=out_dtype, device=x.device)
    _aligned('qmm_int8', x, w_int, scale, row, res, out)
    lib = library('qmm')
    with torch.cuda.device(x.device):
        rc = lib.ppq_qmm_int8(
            x.data_ptr(), w_int.data_ptr(), scale.data_ptr(),
            None if row is None else row.data_ptr(),
            None if res is None else res.data_ptr(),
            int(res is not None and res.dtype == torch.float32),
            out.data_ptr(), int(out_dtype == torch.float32), B, D, F,
            _narrow(F, B), stream_of(x.device))
    check(rc, 'qmm_int8')
    LAUNCHES['qmm_int8'] += 1
    return out


def qmm_gateup(x: torch.Tensor, w_int: torch.Tensor, scale: torch.Tensor,
               out_dtype=torch.bfloat16,
               row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused SwiGLU front half: silu(x @ Wg) * (x @ Wu), the weight being
    the [gate | up] concatenation (D, 2 F) int8. The (B, 2 F) projection
    never reaches device memory. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    _check(x, w_int, scale, out_dtype, 'qmm_gateup')
    if x.device.type == 'cpu':
        return qmm_gateup_plain(x, w_int, scale, out_dtype, row_scale)
    if x.device.type != 'cuda':
        raise ValueError(f'qmm_gateup runs on cpu or cuda, not {x.device}')
    B, D = x.shape
    F2 = w_int.shape[1]
    if not supports_gateup(D, F2, B, 8):
        raise ValueError(f'qmm_gateup does not tile D={D}, 2F={F2}')
    F = F2 // 2
    x = x.to(torch.bfloat16).contiguous()
    row = None if row_scale is None else _row(row_scale, B).contiguous()
    out = torch.empty((B, F), dtype=out_dtype, device=x.device)
    _aligned('qmm_gateup', x, w_int, scale, row, out)
    lib = library('qmm')
    with torch.cuda.device(x.device):
        rc = lib.ppq_qmm_gateup(
            x.data_ptr(), w_int.data_ptr(), scale.data_ptr(),
            None if row is None else row.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), B, D, F, _narrow(F, B),
            stream_of(x.device))
    check(rc, 'qmm_gateup')
    LAUNCHES['qmm_gateup'] += 1
    return out
