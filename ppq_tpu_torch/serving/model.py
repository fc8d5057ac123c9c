"""Llama-class decoder: plain functions on tensors, with quantized weights
and an INT8 KV cache. The single-device part of the JAX package's
`ppq_tpu/serving/model.py`, function for function.

  * weights live as INT8 integers (or INT4 nibbles packed split-half,
    `w_packed`) + per-output-channel f32 scales. Decode-sized matmuls go
    through the fused dequant-matmul kernels (kernels/qmm.py), which read the
    integer bytes and apply the scale to the f32 dot result; larger ones
    (prefill) and 16-bit weights take the library product of the weight
    dequantized to bf16, as in the JAX package. The two numerics differ
    (scale before or after the dot) and each is kept where the JAX package
    has it.
  * burst decode reads the frozen cache either densely (every slot's window
    up to the read bucket, as library products) or ragged: through the
    paged-attention kernels (kernels/paged_attention.py), which read only
    each slot's filled positions and return a partial softmax that merges
    exactly with the in-burst buffer.
  * the KV cache stores int8 + per-(token, kv-head) scales; quantize on
    write, scales applied to the logits / probabilities on read.
  * activations run bf16; matrix products round their operands to bf16 and
    accumulate and return f32; attention logits and softmax stay f32.
  * W8A8 (cfg.act_bits == 8): a product over more than one token per row
    block (prefill) quantizes its activations per token to int8 and sums
    int8 x int8 in int32 (`torch._int_mm` on the card, an exact integer
    product on the CPU), then applies both scales; decode keeps the
    weight-only kernels, as in the JAX package.
  * MoE layers (`layer['moe']`, serving/moe.py) replace the SwiGLU FFN by
    the dense top-k expert mixture.
  * the cache and the burst buffers are updated IN PLACE (the JAX functions
    return new arrays and donate the old ones); a Python loop stands where
    `lax.scan` stood.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from ..executor.executor import resolve_device
from ..kernels import bank_write as _bank
from ..kernels import paged_attention as _pa
from ..kernels import qmm as _qmm
from ..kernels import window_write as _window
from .config import LlamaConfig
from .moe import init_moe_params, moe_ffn
from .pipeline import _sp_merge_triple
from .tensor_parallel import ColumnParallel, RowParallel

Params = Dict[str, Any]

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64


# ============================================================ weight quant ==

def _mse_weight_scale(w: np.ndarray, qmax: int, n_grid: int = 32,
                      shrink: float = 0.5) -> np.ndarray:
    """Per-channel MSE-optimal symmetric scale: grid-search shrink factors
    of the absmax range and keep each channel's reconstruction-MSE
    minimizer."""
    absmax = np.maximum(np.abs(w).max(axis=0), 1e-8)        # (out,)
    best_s = absmax / qmax
    best_err = np.full(w.shape[1], np.inf)
    for g in range(n_grid):
        f = 1.0 - shrink * g / n_grid                       # 1.0 -> 0.5+
        s = absmax * f / qmax
        q = np.clip(np.round(w / s), -qmax - 1, qmax)
        err = np.mean((q * s - w) ** 2, axis=0)
        take = err < best_err
        best_err = np.where(take, err, best_err)
        best_s = np.where(take, s, best_s)
    return best_s


def _mse_weight_scale_tensor(w: torch.Tensor, qmax: int, n_grid: int = 32,
                             shrink: float = 0.5) -> torch.Tensor:
    """`_mse_weight_scale` on the device: the same float32 arithmetic, but
    each channel's mean error sums in the device's order, so a channel whose
    errors at two shrink factors lie within rounding of each other may take
    the other one (recorded difference 44)."""
    dev = w.device
    qm = torch.tensor(float(qmax), dtype=F32, device=dev)
    absmax = w.abs().amax(dim=0).clamp_min(1e-8)                # (out,)
    best_s = absmax / qm
    best_err = torch.full_like(best_s, float('inf'))
    for g in range(n_grid):
        f = 1.0 - shrink * g / n_grid                       # 1.0 -> 0.5+
        s = absmax * f / qm
        q = torch.clamp(torch.round(w / s), -qmax - 1, qmax)
        err = torch.mean((q * s - w) ** 2, dim=0)
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_s = torch.where(take, s, best_s)
    return best_s


def quantize_weight(w, bits: int, method: str = 'minmax',
                    device=None) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric weight quantization. w: (in, out), a
    numpy array or a tensor; the result lies on `device` (the card unless
    named), where the division and the rounding run (the same IEEE float32
    arithmetic as numpy's, so codes do not depend on the device for given
    scales). method: 'minmax' (absmax range) or 'mse' (per-channel grid
    search: numpy's on the CPU, bit for bit the JAX package's, the
    device's own on the card)."""
    device = resolve_device(device)
    if bits >= 16:
        return {'w': torch.as_tensor(w).to(device=device, dtype=BF16)}
    qmax = (1 << (bits - 1)) - 1
    if method == 'mse' and device.type == 'cuda':
        wt = torch.as_tensor(w).to(device=device, dtype=F32)
        scale = _mse_weight_scale_tensor(wt, qmax)
    elif method == 'mse':
        w_np = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w,
                          np.float32)
        scale = torch.from_numpy(
            _mse_weight_scale(w_np, qmax).astype(np.float32)).to(device)
        wt = torch.from_numpy(w_np).to(device)
    elif method == 'minmax':
        wt = torch.as_tensor(w).to(device=device, dtype=F32)
        # a tensor divisor: a Python scalar would be turned into a
        # multiplication by its reciprocal on the card
        scale = wt.abs().amax(dim=0).clamp_min(1e-8) / torch.tensor(
            float(qmax), dtype=F32, device=device)
    else:
        raise ValueError(f'unknown weight quant method {method!r}')
    q = torch.round(wt / scale).clamp(-qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        # split-half packing (kernels/qmm.py): byte row r holds w[r] in the
        # low nibble and w[r + in/2] in the high nibble
        return {'w_packed': _qmm.pack_int4_splithalf(q), 'scale': scale}
    return {'w_int': q, 'scale': scale}


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(in//2, out) int8 -> (in, out) int8 in [-8, 7] (split-half layout)."""
    return _qmm.unpack_int4_splithalf(packed)


# rows x depth cap for the fused kernels, as in the JAX package: decode and
# small-batch serving take them, prefill matmuls keep the library product
_KERNEL_QMM_MAX_X_BYTES = 2 * 1024 * 1024


def _a8_quant(x: torch.Tensor):
    """Per-token (last-axis) symmetric int8 activation quantization:
    (int8 codes, float32 scales of shape (..., 1))."""
    xf = x.to(F32)
    ax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    s = torch.clamp_min(ax, 1e-6) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def int8_product(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(R, D) int8 @ (D, F) int8 -> (R, F) int32, exact: the JAX package's
    `lax.dot_general(..., preferred_element_type=int32)`. On the card
    `torch._int_mm` (cuBLASLt's int8 product), its operands padded with
    zeros to its shape rules (more than 16 rows, depth and width multiples
    of 8); on the CPU an int64 product."""
    R, D = q.shape
    Fo = w.shape[1]
    if q.device.type != 'cuda':
        return torch.matmul(q.to(torch.int64), w.to(torch.int64)) \
            .to(torch.int32)
    Rp = max(32, -(-R // 8) * 8)
    Dp, Fp = -(-D // 8) * 8, -(-Fo // 8) * 8
    if (Rp, Dp) != (R, D):
        q = F_.pad(q, (0, Dp - D, 0, Rp - R))
    if (Dp, Fp) != (D, Fo):
        w = F_.pad(w, (0, Fp - Fo, 0, Dp - D))
    out = torch._int_mm(q.contiguous(), w.contiguous())
    return out[:R, :Fo] if (Rp, Fp) != (R, Fo) else out


def _bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 and an f32 result: bf16
    values and their products are exact in f32, so this is the bf16-operand,
    f32-accumulate product up to summation order."""
    return torch.matmul(a.to(BF16).to(F32), b.to(BF16).to(F32))


def qmatmul(x: torch.Tensor, wq: Dict[str, torch.Tensor],
            kernel: bool = False, a8: bool = False,
            row_scale: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ dequant(w), `_qmatmul` on one card. On a rank of a tensor-
    parallel mesh (serving/tensor_parallel.py): a RowParallel weight's
    partial product in float32, all-reduced over 'tp', the residual added
    once after the reduce, then the cast; a ColumnParallel weight's outputs
    all-gathered over 'tp'."""
    if isinstance(wq, RowParallel):
        out = wq.reduce(_qmatmul(x, wq, kernel, a8, row_scale,
                                 out_dtype=F32, shards=wq.shards))
        if residual is not None:
            out = out + residual.to(F32)
        return out.to(x.dtype)
    if isinstance(wq, ColumnParallel):
        return wq.gather(_qmatmul(x, wq, kernel, a8, row_scale, residual))
    return _qmatmul(x, wq, kernel, a8, row_scale, residual)


def _qmatmul(x: torch.Tensor, wq: Dict[str, torch.Tensor],
             kernel: bool = False, a8: bool = False,
             row_scale: Optional[torch.Tensor] = None,
             residual: Optional[torch.Tensor] = None,
             out_dtype: Optional[torch.dtype] = None,
             shards: int = 1) -> torch.Tensor:
    """x @ dequant(w) on this device's weight (out_dtype: x's unless named;
    shards: the weight is one of that many row shards, routed as one card
    routes the whole weight).

    kernel=True routes supported shapes through the fused dequant-matmul
    kernels (INT8 `w_int`, INT4 `w_packed`): the scale multiplies the f32
    dot result. Otherwise the weight is dequantized to bf16 (`w_int * scale`
    or the unpacked nibbles times the scale, rounded to bf16) before the
    dot.

    a8=True (W8A8) on a quantized weight and more than one token in the
    second-to-last axis: per-token int8 activations, an int8 x int8 ->
    int32 product (`int8_product`), then the token and channel scales and
    the epilogue; the engine turns it on with cfg.act_bits == 8, and decode
    (one token) keeps the weight-only paths.

    row_scale (lead-shaped, or (..., 1)): per-row f32 multiplier, the
    folded-rms_norm rsqrt factor. residual (same shape as the output): added
    after all scaling. Both ride the kernel's epilogue.
    """
    lead = x.shape[:-1]
    D = x.shape[-1]
    R = int(np.prod(lead)) if lead else 1
    od = out_dtype or x.dtype

    if a8 and 'w' not in wq and x.dim() >= 2 and x.shape[-2] > 1:
        q, sx = _a8_quant(x)
        w_int = wq['w_int'] if 'w_int' in wq else _unpack_int4(wq['w_packed'])
        acc = int8_product(q.reshape(R, D), w_int)
        flat = acc.to(F32) * sx.reshape(R, 1) * wq['scale'].to(F32)
        if row_scale is not None:
            flat = flat * row_scale.to(F32).reshape(R, 1)
        if residual is not None:
            flat = flat + residual.reshape(R, -1).to(F32)
        return flat.reshape(*lead, -1).to(od)
    Dw = D * shards
    if kernel and 'w' not in wq and R * Dw * 2 <= _KERNEL_QMM_MAX_X_BYTES:
        int4 = 'w_packed' in wq
        wk = wq['w_packed'] if int4 else wq['w_int']
        Fo = wk.shape[1]
        if (_qmm.supports_int4(Dw // 2, Fo, R) and D % 2 == 0) if int4 \
                else _qmm.supports(Dw, Fo, R):
            out = (_qmm.qmm_int4 if int4 else _qmm.qmm_int8)(
                x.reshape(R, D), wk, wq['scale'],
                out_dtype=od if od in (BF16, F32) else F32,
                row_scale=None if row_scale is None
                else row_scale.reshape(R, 1).to(F32),
                residual=None if residual is None
                else residual.reshape(R, Fo))
            return out.reshape(*lead, Fo).to(od)
    if 'w' in wq:
        w = wq['w']
    elif 'w_int' in wq:
        w = wq['w_int'].to(BF16) * wq['scale'].to(BF16)
    else:
        w = _unpack_int4(wq['w_packed']).to(BF16) * wq['scale'].to(BF16)
    out = _bf16_product(x, w)
    flat = out.reshape(R, -1)
    if row_scale is not None:
        flat = flat * row_scale.to(F32).reshape(R, 1)
    if residual is not None:
        flat = flat + residual.reshape(R, -1).to(F32)
    return flat.reshape(out.shape).to(od)


# =============================================================== init ======

def init_llama_params(cfg: LlamaConfig, seed: int = 0,
                      quantized: bool = True, device=None) -> Params:
    """Random-initialized (optionally quantized) parameter tree on `device`
    (the card unless named). The values are drawn with numpy in the JAX
    package's order, so a seed means the same weights in both packages; each
    matrix is quantized on the device."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, H, KV, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    bits = cfg.weight_bits if quantized else 16
    method = getattr(cfg, 'weight_quant_method', 'minmax')

    def dense(i, o, b=None):
        w = rng.standard_normal((i, o), dtype=np.float32) \
            * np.float32(1.0 / np.sqrt(i))
        return quantize_weight(w, b if b is not None else bits,
                               method=method, device=device)

    params: Params = {
        'embed': torch.from_numpy(
            rng.standard_normal((cfg.vocab_size, D), dtype=np.float32)
            * np.float32(0.02)).to(device=device, dtype=BF16),
        'final_norm': torch.ones((D,), dtype=F32, device=device),
        'lm_head': dense(D, cfg.vocab_size,
                         cfg.resolved_lm_head_bits if quantized else 16),
        'layers': [],
    }
    for li in range(cfg.n_layers):
        layer = {
            'attn_norm': torch.ones((D,), dtype=F32, device=device),
            'mlp_norm': torch.ones((D,), dtype=F32, device=device),
            'wq': dense(D, H * Dh),
            'wk': dense(D, KV * Dh),
            'wv': dense(D, KV * Dh),
            'wo': dense(H * Dh, D),
        }
        if cfg.n_experts > 0:
            moe = init_moe_params(D, F, cfg.n_experts, cfg.top_k,
                                  weight_bits=bits, seed=seed * 1000 + li,
                                  device=device)
            moe.pop('top_k')
            moe.pop('n_experts')
            layer['moe'] = moe
        else:
            layer['w_gate'] = dense(D, F)
            layer['w_up'] = dense(D, F)
            layer['w_down'] = dense(F, D)
        params['layers'].append(layer)
    return params


def _concat_qweights(parts):
    """Concatenate quantized-weight dicts along the OUTPUT axis. Column
    dequant `w_int[:, c] * scale[c]` is independent per column, so the
    concatenated matmul is numerically identical to the separate ones."""
    keys = set(parts[0])
    assert all(set(p) == keys for p in parts), 'mixed weight formats'
    return {k: torch.cat([p[k] for p in parts], dim=-1).contiguous()
            for k in ('w', 'w_int', 'w_packed', 'scale') if k in keys}


def fold_norm_gamma(params: Params) -> bool:
    """Fold each rms_norm's gamma into the row scaling of the matmul it
    feeds (attn_norm -> wq/wk/wv|wqkv, mlp_norm -> gate/up|gateup,
    final_norm -> lm_head), setting the stored gamma to ones. After this,
    rms_norm(x, ones, eps) @ W' is the original math, and hot paths may use
    the fused row_rsqrt epilogue instead. MUTATES params in place (weight
    dicts are copied before scaling).

    Folding needs fp weights ('w' present, pre-quantization); gammas that
    are already all-ones fold trivially. Returns True only if EVERY norm
    folded, never for a model with MoE layers."""
    def fold(owner, gkey, wkeys):
        g = owner[gkey].to(F32)
        if bool(torch.all(g == 1.0)):
            return True
        wqs = [owner.get(k) for k in wkeys]
        if not all(wq is not None and 'w' in wq for wq in wqs):
            return False
        for k, wq in zip(wkeys, wqs):
            new = dict(wq)
            new['w'] = (new['w'].to(F32) * g[:, None]).to(new['w'].dtype)
            owner[k] = new
        owner[gkey] = torch.ones_like(owner[gkey])
        return True

    ok = True
    for layer in params['layers']:
        if 'moe' in layer:
            ok = False      # router / expert folding is not attempted
            continue
        ok &= fold(layer, 'attn_norm',
                   ('wqkv',) if 'wqkv' in layer else ('wq', 'wk', 'wv'))
        ok &= fold(layer, 'mlp_norm',
                   ('w_gateup',) if 'w_gateup' in layer
                   else ('w_gate', 'w_up'))
    ok &= fold(params, 'final_norm', ('lm_head',))
    return ok


def fuse_decode_params(params: Params, cfg: LlamaConfig) -> Params:
    """Fuse per-layer projections for the decode hot loop: wq|wk|wv ->
    'wqkv' and w_gate|w_up -> 'w_gateup' (one matmul launch instead of
    three/two). Model code uses the fused keys when present and falls back
    to the separate ones. Sets cfg.norm_folded when every norm's gamma
    folded, and pads a quantized lm_head's output axis to a multiple of
    1024 with zero weights (exactly-zero logits; every consumer slices the
    logits to cfg.vocab_size)."""
    out = dict(params)
    layers = []
    for layer in params['layers']:
        lay = dict(layer)
        if 'wq' in lay:
            lay['wqkv'] = _concat_qweights(
                [lay.pop('wq'), lay.pop('wk'), lay.pop('wv')])
        if 'w_gate' in lay:
            lay['w_gateup'] = _concat_qweights(
                [lay.pop('w_gate'), lay.pop('w_up')])
        layers.append(lay)
    out['layers'] = layers
    if fold_norm_gamma(out):
        cfg.norm_folded = True
    lm = out.get('lm_head', {})
    Fo = next(iter(lm.values())).shape[-1] if lm else 0
    pad = (-Fo) % 1024
    if pad and 'w' not in lm:
        key = 'w_int' if 'w_int' in lm else 'w_packed'
        out['lm_head'] = {
            key: F_.pad(lm[key], (0, pad)).contiguous(),
            'scale': F_.pad(lm['scale'], (0, pad), value=1.0).contiguous()}
    return out


def project_qkv(h, layer, cfg: LlamaConfig, kern: bool, row_scale=None):
    """(B, T, D) -> q (B,T,H,Dh), k/v (B,T,KV,Dh) via the fused 'wqkv'
    weight when present, else the separate projections. row_scale: the
    folded-attn_norm rsqrt factor (pass raw x as h in that case)."""
    B, T, _ = h.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a8 = cfg.act_bits == 8
    if 'wqkv' in layer:
        qkv = qmatmul(h, layer['wqkv'], kernel=kern, a8=a8,
                      row_scale=row_scale)
        q = qkv[..., :H * Dh].reshape(B, T, H, Dh)
        k = qkv[..., H * Dh:(H + KV) * Dh].reshape(B, T, KV, Dh)
        v = qkv[..., (H + KV) * Dh:].reshape(B, T, KV, Dh)
        return q, k, v
    q = qmatmul(h, layer['wq'], kernel=kern, a8=a8,
                row_scale=row_scale).reshape(B, T, H, Dh)
    k = qmatmul(h, layer['wk'], kernel=kern, a8=a8,
                row_scale=row_scale).reshape(B, T, KV, Dh)
    v = qmatmul(h, layer['wv'], kernel=kern, a8=a8,
                row_scale=row_scale).reshape(B, T, KV, Dh)
    return q, k, v


def quantize_llama_params(params: Params, cfg: LlamaConfig,
                          method: str = None) -> Params:
    """PTQ an existing bf16 param tree (per-channel symmetric). method:
    'minmax' | 'mse' (defaults to cfg.weight_quant_method)."""
    method = method or getattr(cfg, 'weight_quant_method', 'minmax')

    def q(wq, bits=None):
        if 'w' not in wq:
            return wq
        return quantize_weight(wq['w'].to(F32), bits or cfg.weight_bits,
                               method=method, device=wq['w'].device)
    out = dict(params)
    out['lm_head'] = q(params['lm_head'], cfg.resolved_lm_head_bits)
    out['layers'] = [{k: (q(v) if isinstance(v, dict) else v)
                      for k, v in layer.items()}
                     for layer in params['layers']]
    return out


# ============================================================ components ===

def rms_norm(x, gamma, eps, exact: bool = False):
    """exact: the mean of squares sums in float64, where the squares of
    bf16 values and their sum are exact, so a row's result does not depend
    on how many rows the reduction runs over (cfg.batch_invariant)."""
    xf = x.to(F32)
    if exact:
        var = torch.mean(torch.square(x.to(F64)), dim=-1,
                         keepdim=True).to(F32)
    else:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def row_rsqrt(x, eps):
    """The data-dependent half of rms_norm: rsqrt(mean(x^2) + eps) as a
    per-row f32 scalar, shape = x.shape[:-1]. With the norm's gamma folded
    into the following matmul's weights, the full pre-norm matmul is
    row_rsqrt(x) * (x @ W'): the row scalar commutes with the dot and rides
    the matmul kernel's epilogue."""
    var = torch.mean(torch.square(x.to(F32)), dim=-1)
    return torch.rsqrt(var + eps)


def rope_tables(positions, theta, Dh):
    """cos/sin tables for `rope_apply`: positions (B, T) -> (B, T, 1, Dh/2).
    Position-only, so decode loops compute them ONCE per step."""
    half = Dh // 2
    exponent = torch.arange(0, half, dtype=F32, device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exponent)
    angles = positions[..., None].to(F32) * freqs            # (B,T,half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rope_apply(x, cos, sin):
    """x: (B, T, H, Dh); cos/sin from rope_tables."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x, positions, theta):
    """x: (B, T, H, Dh); positions: (B, T)."""
    cos, sin = rope_tables(positions, theta, x.shape[-1])
    return rope_apply(x, cos, sin)


# ======================================================== KV cache (int8) ==

def init_kv_cache(cfg: LlamaConfig, batch: int,
                  device=None) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    KV, Dh, T, L = cfg.n_kv_heads, cfg.head_dim, cfg.max_seq_len, cfg.n_layers
    if cfg.kv_cache_bits == 8:
        return {
            'k': torch.zeros((L, batch, T, KV, Dh), dtype=torch.int8, device=device),
            'v': torch.zeros((L, batch, T, KV, Dh), dtype=torch.int8, device=device),
            'k_scale': torch.zeros((L, batch, T, KV), dtype=F32, device=device),
            'v_scale': torch.zeros((L, batch, T, KV), dtype=F32, device=device),
        }
    return {
        'k': torch.zeros((L, batch, T, KV, Dh), dtype=BF16, device=device),
        'v': torch.zeros((L, batch, T, KV, Dh), dtype=BF16, device=device),
    }


def _kv_quant(x):
    """Per-(token, head) int8 quantization of K or V: (B,T,KV,Dh)."""
    xf = x.to(F32)
    absmax = torch.amax(torch.abs(xf), dim=-1)                     # (B,T,KV)
    scale = torch.clamp_min(absmax / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]),
                    -128, 127).to(torch.int8)
    return q, scale


def _kv_dequant(q, scale):
    return q.to(F32) * scale[..., None]


# ============================================================== forward ====

def _window_write(cache_slab, new, write_pos, active):
    """Write a (B, T, ...) window into a (B, S, ...) cache slab at per-slot
    offsets, IN PLACE. Inactive slots write their current window back
    (no-op). The start is clamped so that the window fits, as a dynamic
    update slice clamps it. No host read of write_pos or active."""
    B, T = new.shape[:2]
    S = cache_slab.shape[1]
    start = write_pos.to(torch.int64).clamp(0, S - T)
    rows = start[:, None] + torch.arange(T, device=new.device)     # (B, T)
    slots = torch.arange(B, device=new.device)[:, None].expand(B, T)
    new = new.to(cache_slab.dtype)
    if active is not None:
        cur = cache_slab[slots, rows]
        new = torch.where(active.reshape((B,) + (1,) * (new.dim() - 1)),
                          new, cur)
    cache_slab[slots, rows] = new
    return cache_slab


class SeqShard(NamedTuple):
    """A rank's share of a dense cache whose sequence axis is sharded over
    'sp' (`tensor_parallel.cache_shardings`): positions [start, start +
    size) of every slot, of `total` in all; reads merge their partial
    softmaxes over `groups`."""
    start: int
    size: int
    total: int
    groups: tuple


def seq_shard(cache: Dict[str, torch.Tensor], sp_mesh,
              cfg: LlamaConfig) -> Optional[SeqShard]:
    """The SeqShard of this rank's cache on `sp_mesh` (None: no mesh, a
    one-rank sp axis, or a cache that holds every position)."""
    n = 1 if sp_mesh is None else sp_mesh.shape.get('sp', 1)
    size = cache['k'].shape[2]
    if n == 1 or size == cfg.max_seq_len:
        return None
    return SeqShard(sp_mesh.index('sp') * size, size, size * n,
                    (sp_mesh.group('sp'),))


def _run_layers(x: torch.Tensor, body, stages=None) -> torch.Tensor:
    """body(h, part, rows) -> h runs this rank's layers on the batch rows
    `rows` (a slice) of microbatch `part`: once over the whole batch on one
    card, on a pipeline (`stages`, a `pipeline._Stages`) on each of the
    stage's microbatches as the schedule brings them. Returns the last
    layer's (B, ...) output on every rank."""
    if stages is None:
        return body(x, 0, slice(None))
    return stages.run(x, body)


def _shard_window(slabs, news, write_pos, active, shard: SeqShard):
    """The part of windows written at global write_pos that lands in this
    rank's positions, as windows of W = min(T, shard.size) rows at local
    offsets: (offsets (B,) int32, [(L, B, W, ...) windows]). slabs (L, B,
    S_local, ...) and news (L, B, T, ...) pair up; a window row where no
    token lands holds the slab's current row, so the write is a plain one
    with no duplicate index. The global start is clamped as one card's
    window write clamps it."""
    B, T = news[0].shape[1:3]
    S = shard.size
    W = min(T, S)
    dev = slabs[0].device
    start = write_pos.to(torch.int64).clamp(0, max(shard.total - T, 0))
    lw = start - shard.start                      # local row of token 0
    off = lw.clamp(0, S - W)
    rows = off[:, None] + torch.arange(W, device=dev)          # (B, W)
    tok = rows - lw[:, None]
    valid = (tok >= 0) & (tok < T)
    if active is not None:
        valid = valid & active.to(torch.bool)[:, None]
    slots = torch.arange(B, device=dev)[:, None].expand(B, W)
    tok = tok.clamp(0, T - 1)
    out = []
    for slab, new in zip(slabs, news):
        keep = valid.reshape((1, B, W) + (1,) * (slab.dim() - 3))
        out.append(torch.where(keep, new[:, slots, tok].to(slab.dtype),
                               slab[:, slots, rows]).contiguous())
    return off.to(torch.int32).contiguous(), out


def _local_triple(q_g, k, v, ks, vs, mask, Dh, exact=False):
    """The partial softmax of q_g (B, T, KV, rep, Dh) over the cache rows
    k, v (B, S, KV, Dh) (scales (B, S, KV) or None) where `mask` (B, 1, 1,
    T, S) holds: (acc (B, T, KV, rep, Dh), m, l (B, T, KV, rep)), the
    one-card attention's numerics up to where p rounds; a row with no key
    is empty (m = -1e30, l = 0, acc = 0)."""
    s = _qk_logits(q_g, k, exact)                          # (B,KV,rep,T,S)
    if ks is not None:
        s = s * ks.transpose(1, 2)[:, :, None, None, :]
    s = torch.where(mask, s / math.sqrt(Dh), -1e30)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    if vs is not None:
        p = p * vs.transpose(1, 2)[:, :, None, None, :]
    acc = _pv_context(p, v, exact)
    return acc, m.permute(0, 3, 1, 2), l.permute(0, 3, 1, 2)


def _heads_first(kv: torch.Tensor) -> torch.Tensor:
    """(B, S, KV, Dh) int8 codes or bf16 values -> (B, KV, S, Dh) f32
    (exact), contiguous, in one pass."""
    if kv.dtype not in (torch.int8, BF16):
        kv = kv.to(BF16)
    return kv.permute(0, 2, 1, 3).to(
        F32, memory_format=torch.contiguous_format)


def _qk_logits(q_g: torch.Tensor, k: torch.Tensor,
               exact: bool = False) -> torch.Tensor:
    """einsum('btkrd,bskd->bkrts') with bf16 operands and an f32 result.
    q_g: (B, T, KV, rep, Dh); k: (B, S, KV, Dh) -> (B, KV, rep, T, S).
    exact: the product sums in float64, where the products of bf16
    operands and their sums are exact, then rounds once to f32: a row's
    logits do not depend on how many rows the library product tiles
    (cfg.batch_invariant)."""
    B, T, KV, rep, Dh = q_g.shape
    acc = F64 if exact else F32
    qf = q_g.to(BF16).to(acc).permute(0, 2, 3, 1, 4).reshape(B, KV, rep * T,
                                                            Dh)
    out = torch.matmul(qf, _heads_first(k).to(acc).transpose(-1, -2))
    return out.to(F32).reshape(B, KV, rep, T, k.shape[1])


def _pv_context(p: torch.Tensor, v: torch.Tensor,
                exact: bool = False) -> torch.Tensor:
    """einsum('bkrts,bskd->btkrd') with bf16 operands and an f32 result.
    p: (B, KV, rep, T, S); v: (B, S, KV, Dh) -> (B, T, KV, rep, Dh).
    exact: as `_qk_logits`."""
    B, KV, rep, T, S = p.shape
    acc = F64 if exact else F32
    pf = p.to(BF16).to(acc).reshape(B, KV, rep * T, S)
    out = torch.matmul(pf, _heads_first(v).to(acc))          # (B,KV,rep*T,Dh)
    return out.to(F32).reshape(B, KV, rep, T, -1).permute(0, 3, 1, 2, 4)


def attention(x, layer, cache_k, cache_v, cache_ks, cache_vs,
              positions, write_pos, cfg: LlamaConfig, causal_mask,
              active=None, shard: Optional[SeqShard] = None):
    """One attention block over an int8 KV cache layer slab.

    x: (B, T, D); positions: (B, T) absolute positions of the T new tokens;
    write_pos: (B,) first cache slot to write; active: optional (B,) bool:
    slots with active=False keep their cache rows untouched. The layer's
    slabs (views of the cache) are written in place. Returns (out, slabs).

    QK^T runs as a grouped-GQA product against the cache's codes (the
    per-(token, head) scales multiply the (T, S) logits afterwards), and the
    V readout folds its scales into the probabilities first.

    shard: the slabs hold this rank's positions of a sequence-sharded cache
    (causal_mask in its local columns): the window's tokens that land there
    are written, the rank's partial softmax is merged over the shard's
    groups (`pipeline._sp_merge_triple`), and every rank gets the context.
    """
    B, T, D = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    kern = bool(cfg.use_kernel_matmul)
    int8 = cfg.kv_cache_bits == 8

    q, k, v = project_qkv(x, layer, cfg, kern)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if int8:
        k_q, k_s = _kv_quant(k)
        v_q, v_s = _kv_quant(v)
    else:
        k_q, v_q, k_s, v_s = k.to(BF16), v.to(BF16), None, None

    # q heads regroup as (KV, rep): head h = k*rep + r
    exact = cfg.batch_invariant
    q_g = q.reshape(B, T, KV, rep, Dh)
    if shard is not None:
        slabs = (cache_k, cache_v) + ((cache_ks, cache_vs) if int8 else ())
        news = (k_q, v_q) + ((k_s, v_s) if int8 else ())
        off, wins = _shard_window([t[None] for t in slabs],
                                  [t[None] for t in news], write_pos, active,
                                  shard)
        for slab, win in zip(slabs, wins):
            _window_write(slab, win[0], off, None)
        acc, m, l = _local_triple(q_g, cache_k, cache_v, cache_ks, cache_vs,
                                  causal_mask, Dh, exact)
        acc, _, l = _sp_merge_triple(acc, m, l, shard.groups)
        ctx = acc / torch.clamp_min(l, 1e-30)[..., None]
    else:
        cache_k = _window_write(cache_k, k_q, write_pos, active)
        cache_v = _window_write(cache_v, v_q, write_pos, active)
        if int8:
            cache_ks = _window_write(cache_ks, k_s, write_pos, active)
            cache_vs = _window_write(cache_vs, v_s, write_pos, active)
        logits = _qk_logits(q_g, cache_k, exact)
        if int8:
            logits = logits * cache_ks.transpose(1, 2)[:, :, None, None, :]
        logits = logits / math.sqrt(Dh)
        logits = torch.where(causal_mask, logits, -1e30)  # mask: (B,1,1,T,S)
        probs = torch.softmax(logits, dim=-1)
        if int8:
            probs = probs * cache_vs.transpose(1, 2)[:, :, None, None, :]
        ctx = _pv_context(probs, cache_v, exact)
    ctx = ctx.reshape(B, T, H * Dh).to(x.dtype)
    out = qmatmul(ctx, layer['wo'], kernel=kern, a8=cfg.act_bits == 8)
    return out, cache_k, cache_v, cache_ks, cache_vs


def mlp(x, layer, cfg=None, row_scale=None, residual=None):
    """SwiGLU FFN. row_scale: folded-norm rsqrt factor (see
    fold_norm_gamma); residual: fused into the down-projection epilogue. On
    the kernel decode path gate/up/silu/mul run inside ONE kernel
    (kernels/qmm.py qmm_gateup): the (B, 2*d_ff) projection never reaches
    device memory. With cfg.act_bits == 8 every product takes `a8` and the
    fused gate|up kernel is skipped, as in the JAX package. A MoE layer
    runs serving/moe.py's expert mixture (no folded-norm row scale: the
    fold refuses MoE models), the residual added after."""
    if 'moe' in layer:
        if row_scale is not None:
            raise ValueError('a folded-norm row scale reached a MoE layer; '
                             'fold_norm_gamma refuses MoE models')
        out = moe_ffn(x, layer['moe'],
                      top_k=cfg.top_k if cfg is not None else 2)
        return out if residual is None else residual + out
    kern = bool(cfg.use_kernel_matmul) if cfg is not None else False
    a8 = cfg is not None and cfg.act_bits == 8
    lead = x.shape[:-1]
    D = x.shape[-1]
    R = int(np.prod(lead)) if lead else 1
    if (kern and not a8 and 'w_gateup' in layer
            and 'w' not in layer['w_gateup']
            and R * D * 2 <= _KERNEL_QMM_MAX_X_BYTES):
        wgu = layer['w_gateup']
        wkey = 'w_int' if 'w_int' in wgu else 'w_packed'
        bits = 8 if wkey == 'w_int' else 4
        if _qmm.supports_gateup(D, wgu[wkey].shape[1], R, bits):
            act = _qmm.qmm_gateup(
                x.reshape(R, D), wgu[wkey], wgu['scale'],
                row_scale=None if row_scale is None
                else row_scale.reshape(R, 1))
            act = act.reshape(*lead, act.shape[-1]).to(x.dtype)
            return qmatmul(act, layer['w_down'], kernel=kern,
                           residual=residual)
    if 'w_gateup' in layer:
        gu = qmatmul(x, layer['w_gateup'], kernel=kern, a8=a8,
                     row_scale=row_scale)
        Fh = gu.shape[-1] // 2
        g, u = gu[..., :Fh], gu[..., Fh:]
    else:
        g = qmatmul(x, layer['w_gate'], kernel=kern, a8=a8,
                    row_scale=row_scale)
        u = qmatmul(x, layer['w_up'], kernel=kern, a8=a8,
                    row_scale=row_scale)
    return qmatmul(F_.silu(g.to(F32)).to(x.dtype) * u,
                   layer['w_down'], kernel=kern, a8=a8, residual=residual)


def decoder_layer(layer, ck, cv, cks, cvs, x, positions, write_pos, cfg,
                  causal, active=None, shard: Optional[SeqShard] = None):
    """One decoder layer over its cache slabs: pre-norm attention + MLP.
    x: (B, T, D); slabs: (B, S, KV, Dh) / (B, S, KV), written in place
    (shard: this rank's positions of a sequence-sharded cache).
    Returns (x, ck, cv, cks, cvs)."""
    exact = cfg.batch_invariant
    h = rms_norm(x, layer['attn_norm'], cfg.rms_eps, exact)
    attn_out, ck, cv, cks, cvs = attention(
        h, layer, ck, cv, cks, cvs, positions, write_pos, cfg, causal,
        active=active, shard=shard)
    x = x + attn_out
    h = rms_norm(x, layer['mlp_norm'], cfg.rms_eps, exact)
    x = x + mlp(h, layer, cfg)
    return x, ck, cv, cks, cvs


def burst_forward(params: Params, cache: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, seq_lens: torch.Tensor,
                  n_steps: int, cfg: LlamaConfig, select_fn,
                  s_limit: Optional[int] = None, ragged: bool = False,
                  prefer_grouped: bool = True,
                  chunk: Optional[int] = None, sp_mesh=None, stages=None):
    """n consecutive decode steps with the big KV cache FROZEN: in-burst K/V
    live in small (L, B, n, KV, Dh) buffers; the cache is written ONCE at
    burst end (one window write for k and v), so a burst equals the same
    steps taken one by one.

    s_limit bounds the frozen-cache READ to the first s_limit slots (a
    bucket the engine picks as the smallest power of two covering
    max(seq_lens)); writes still land in the full cache.

    ragged=True reads the frozen cache through the paged-attention kernels
    (kernels/paged_attention.py): each slot's filled positions only, as a
    partial softmax (acc, m, l) that `merge_attention` joins exactly with the
    in-burst buffer's. The window [0, cap) (cap: s_limit rounded up to 32)
    is repacked ONCE per burst, all layers in one stacked (L, ...) pool that
    the kernels index with `layer=`, at an adaptive block size RBLK. With
    prefer_grouped (the engine's shallow or mixed fills, and every window of
    64 slots or fewer) the window is block-major and the grouped kernel
    reads it, `grouped_group_size` slots sharing a loop bound; otherwise the
    fused kernel reads it slot by slot through identity block tables. The
    choices of cap, RBLK and G are the JAX package's.

    chunk: the burst's columns are read in chunks of that many; the current
    chunk masked, finished chunks unmasked (the JAX package's chunked scan
    carry; here the chunks are views of one buffer).

    With buffers whose head dim is a multiple of 128 each step's codes are
    banked at the END of the step by one bank-write launch over all layers
    (kernels/bank_write.py): the step's own column is then masked strictly
    and the current token attends through a 1-wide chunk built from the same
    codes. Other head dims write the column at once and read it back.

    sp_mesh: the cache holds this rank's positions of a sequence-sharded
    cache (`seq_shard`): the frozen read covers them (the ragged one with
    the local fills, clamp(fill - start, 0, S_local)), its partial softmax
    merges over 'sp' (`pipeline._sp_merge_triple`) before the buffer's, and
    the burst's window lands where its positions are. The JAX package leaves
    this to GSPMD (recorded difference 56). stages: a `pipeline._Stages`:
    the layers and cache slabs are this rank's stage's, run on its
    microbatches, each repacked on its own (`pipeline.burst_forward_staged`).

    tokens: (B,) current token per slot; seq_lens: (B,) int32 cache fill;
    select_fn(logits (B, vocab) f32, step index) -> (B,) next tokens.
    Returns (toks (n, B) int32, the cache, updated in place).
    """
    layers = params['layers']
    L = len(layers)
    B = tokens.shape[0]
    n = int(n_steps)
    KV, Dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rep = H // KV
    shard = seq_shard(cache, sp_mesh, cfg)
    if shard is not None and s_limit is not None:
        raise ValueError('a sequence-sharded cache is read whole (no '
                         's_limit): a read bucket would slice a sharded axis')
    S = cache['k'].shape[2]
    if s_limit is not None:
        S = min(s_limit, S)
    int8_cache = cfg.kv_cache_bits == 8
    kern = bool(cfg.use_kernel_matmul)
    folded = bool(cfg.norm_folded)
    a8 = cfg.act_bits == 8        # one token a row: the weight-only paths
    dev = tokens.device
    seq_lens = seq_lens.to(torch.int32).contiguous()
    root_dh = math.sqrt(Dh)
    # the fills of the positions this rank holds
    fills = seq_lens if shard is None else torch.clamp(
        seq_lens - shard.start, 0, shard.size).to(torch.int32).contiguous()

    buf_dtype = torch.int8 if int8_cache else BF16
    if chunk is not None:
        CH = chunk if (n > chunk and n % chunk == 0) else n
    else:
        CH = n
    bank_kernel = _bank.supports_bank((B, CH, KV, Dh))
    kbuf = torch.zeros((L, B, n, KV, Dh), dtype=buf_dtype, device=dev)
    vbuf = torch.zeros((L, B, n, KV, Dh), dtype=buf_dtype, device=dev)
    # buffer scales live TRANSPOSED (L, B, KV, n): columns last is what the
    # logits broadcast wants
    ksb = torch.zeros((L, B, KV, n), dtype=F32, device=dev)
    vsb = torch.zeros((L, B, KV, n), dtype=F32, device=dev)
    slot_ids = torch.arange(S, device=dev)[None, None, None, :]
    buf_ids = torch.arange(CH, device=dev)[None, None, None, :]
    frozen_mask = slot_ids < fills[:, None, None, None]      # (B,1,1,S)
    # the bank kernel reads its column from device memory
    columns = torch.arange(CH, dtype=torch.int32, device=dev)
    M = 1 if stages is None else stages.microbatches

    if ragged:
        Sf = cache['k'].shape[2]
        if Sf % 128 or Dh % 128:
            raise ValueError(f'ragged attention needs max_seq_len and '
                             f'head_dim multiples of 128, not {Sf}, {Dh}')
        # only the window [0, cap) can hold tokens this burst
        cap = Sf if s_limit is None else min(-(-s_limit // 32) * 32, Sf)
        if cap <= 64:
            prefer_grouped = True    # shallow windows: grouped, one block
        if prefer_grouped:
            RBLK = cap if cap <= 64 else max(32, min(512, cap // 2))
        elif cap <= 512:
            RBLK = cap               # deep fills: one block per slot
        elif cap % 512 == 0:
            RBLK = 512
        else:
            RBLK = max(128, min(512, cap // 2))
        G = _pa.grouped_group_size(B // M, RBLK, kv_dh=KV * Dh,
                                   itemsize=1 if int8_cache else 2) \
            if prefer_grouped else 1
        repack = _pa.blockmajor_window if G > 1 else _pa.slotmajor_window
        # each microbatch's window (one on one card), repacked once
        windows = []
        for part in range(M):
            rows = slice(part * B // M, (part + 1) * B // M)
            windows.append(repack(
                cache['k'][:, rows], cache['v'][:, rows],
                cache['k_scale'][:, rows] if int8_cache else None,
                cache['v_scale'][:, rows] if int8_cache else None, cap, RBLK))
        tbl = None if G > 1 else _pa.identity_block_tables(B // M, cap, RBLK,
                                                           dev)

    def buf_readout(pb, v_chunks, vs_chunks):
        """sum over chunks of (p * v_scale, rounded to bf16) @ v_chunk:
        (b, KV, rep, cols) -> (b, 1, KV, rep, Dh) f32."""
        acc = None
        off = 0
        for vc, vs in zip(v_chunks, vs_chunks):
            w = vc.shape[1]
            p = pb[..., off:off + w]
            off += w
            if int8_cache:
                p = p * vs[:, :, None, :]
            t = _pv_context(p[:, :, :, None, :], vc)
            acc = t if acc is None else acc + t
        return acc

    def buf_logits(q_g, buf, scales, lim):
        """q against (b, cols, KV, Dh) codes -> (b, KV, rep, cols); lim:
        columns below it are valid (None = all)."""
        t = _qk_logits(q_g, buf)[:, :, :, 0, :]
        if int8_cache:
            t = t * scales[:, :, None, :]
        if lim is not None:
            return torch.where(buf_ids < lim, t / root_dh, -1e30)
        return t / root_dh

    cur_tok = tokens
    toks = []
    bank = None
    for i in range(n):
        c0 = (i // CH) * CH
        ic = i - c0
        span = slice(c0, c0 + CH)
        if bank_kernel and ic == 0:
            # this chunk's buffers (views of the burst buffers), checked once
            bank = _bank.Bank([kbuf[li][:, span] for li in range(L)]
                              + [vbuf[li][:, span] for li in range(L)])
        pos = seq_lens + i                                   # (B,)
        x = params['embed'][cur_tok.long()][:, None, :]      # (B,1,D)
        # rope tables depend only on pos: ONE build per step
        r_cos, r_sin = rope_tables(pos[:, None], cfg.rope_theta, Dh)
        # per-layer (b,1,KV,Dh) banked codes, a part a microbatch
        newk, newv = [[] for _ in range(L)], [[] for _ in range(L)]

        def body(x, part, rows):
            b = x.shape[0]
            for li, layer in enumerate(layers):
                if folded:
                    q, k, v = project_qkv(x, layer, cfg, kern,
                                          row_scale=row_rsqrt(x, cfg.rms_eps))
                else:
                    h = rms_norm(x, layer['attn_norm'], cfg.rms_eps)
                    q, k, v = project_qkv(h, layer, cfg, kern)
                q = rope_apply(q, r_cos[rows], r_sin[rows])
                k = rope_apply(k, r_cos[rows], r_sin[rows])
                kb, vb = kbuf[li][rows], vbuf[li][rows]
                ksl, vsl = ksb[li][rows], vsb[li][rows]
                # quantize this step's K/V exactly like the cache so that
                # burst == step by step
                if int8_cache:
                    k_q, k_s = _kv_quant(k)
                    v_q, v_s = _kv_quant(v)
                    ks_cur = k_s.transpose(1, 2)             # (b,KV,1)
                    vs_cur = v_s.transpose(1, 2)
                    ksl[:, :, i:i + 1] = ks_cur
                    vsl[:, :, i:i + 1] = vs_cur
                else:
                    k_q, v_q = k.to(buf_dtype), v.to(buf_dtype)
                    ks_cur = vs_cur = None
                if bank_kernel:
                    newk[li].append(k_q.contiguous())
                    newv[li].append(v_q.contiguous())
                else:
                    kb[:, i] = k_q[:, 0]
                    vb[:, i] = v_q[:, 0]

                q_g = q.reshape(b, 1, KV, rep, Dh)
                # in-burst logits: finished chunks (fully valid) + the masked
                # current chunk (+ the current token as a 1-wide chunk)
                lb_parts, v_chunks, vs_chunks = [], [], []
                for f0 in range(0, c0, CH):
                    fin = slice(f0, f0 + CH)
                    lb_parts.append(buf_logits(q_g, kb[:, fin],
                                               ksl[:, :, fin], None))
                    v_chunks.append(vb[:, fin])
                    vs_chunks.append(vsl[:, :, fin])
                lb_parts.append(buf_logits(q_g, kb[:, span], ksl[:, :, span],
                                           ic if bank_kernel else ic + 1))
                v_chunks.append(vb[:, span])
                vs_chunks.append(vsl[:, :, span])
                if bank_kernel:
                    lb_parts.append(buf_logits(q_g, k_q, ks_cur, None))
                    v_chunks.append(v_q)
                    vs_chunks.append(vs_cur)
                lb = torch.cat(lb_parts, dim=-1) if len(lb_parts) > 1 \
                    else lb_parts[0]

                ck, cv = cache['k'][li][rows, :S], cache['v'][li][rows, :S]
                cks = cache['k_scale'][li][rows, :S] if int8_cache else None
                cvs = cache['v_scale'][li][rows, :S] if int8_cache else None
                if ragged or shard is not None:
                    # the frozen part as a partial softmax (on a sharded
                    # cache this rank's, merged over 'sp'); the buffer joins
                    # by an exact merge of the two
                    if not ragged:
                        acc_f, m_f, l_f = (t[:, 0] for t in _local_triple(
                            q_g, ck, cv, cks, cvs, frozen_mask[rows, None],
                            Dh))
                    elif G > 1:
                        acc_f, m_f, l_f = _pa.paged_attention_decode_grouped(
                            q_g[:, 0], windows[part][0], windows[part][1],
                            fills[rows], layer=li, block_size=RBLK, group=G)
                    else:
                        acc_f, m_f, l_f = _pa.paged_attention_decode_fused(
                            q_g[:, 0], windows[part][0], windows[part][1],
                            tbl, fills[rows], layer=li, block_size=RBLK)
                    if shard is not None:
                        acc_f, m_f, l_f = _sp_merge_triple(acc_f, m_f, l_f,
                                                           shard.groups)
                    m_b = lb.amax(-1)                        # (b,KV,rep)
                    p_b = torch.exp(lb - m_b[..., None])
                    l_b = p_b.sum(-1)
                    acc_b = buf_readout(p_b, v_chunks, vs_chunks)[:, 0]
                    ctx = _pa.merge_attention([(acc_f, m_f, l_f),
                                               (acc_b, m_b, l_b)])
                else:
                    # frozen-cache logits (codes read, scales folded post-dot)
                    lf = _qk_logits(q_g, ck)[:, :, :, 0, :]
                    if int8_cache:
                        lf = lf * cks.transpose(1, 2)[:, :, None, :]
                    lf = torch.where(frozen_mask[rows], lf / root_dh, -1e30)

                    probs = torch.softmax(torch.cat([lf, lb], dim=-1), dim=-1)
                    pf, pb = probs[..., :S], probs[..., S:]
                    if int8_cache:
                        pf = pf * cvs.transpose(1, 2)[:, :, None, :]
                    ctx = _pv_context(pf[:, :, :, None, :], cv) \
                        + buf_readout(pb, v_chunks, vs_chunks)
                ctx = ctx.reshape(b, 1, H * Dh).to(x.dtype)
                if folded:
                    # residual adds + norms ride the kernels' epilogues
                    x = qmatmul(ctx, layer['wo'], kernel=kern, a8=a8,
                                residual=x)
                    x = mlp(x, layer, cfg, row_scale=row_rsqrt(x, cfg.rms_eps),
                            residual=x)
                else:
                    x = x + qmatmul(ctx, layer['wo'], kernel=kern, a8=a8)
                    h = rms_norm(x, layer['mlp_norm'], cfg.rms_eps)
                    x = x + mlp(h, layer, cfg)
            return x
        x = _run_layers(x, body, stages)
        if bank_kernel:
            # one launch banks every layer's codes in place
            _bank.bank_write_inplace(
                bank, [torch.cat(p) if len(p) > 1 else p[0]
                       for p in newk + newv], columns[ic:ic + 1])
        if folded:
            logits = qmatmul(x, params['lm_head'], kernel=kern, a8=a8,
                             row_scale=row_rsqrt(x, cfg.rms_eps)).to(F32)
        else:
            x = rms_norm(x, params['final_norm'], cfg.rms_eps)
            logits = qmatmul(x, params['lm_head'], kernel=kern,
                             a8=a8).to(F32)
        cur_tok = select_fn(logits[:, 0, :cfg.vocab_size], i).to(torch.int32)
        toks.append(cur_tok)

    # merge the burst buffers into the cache: the k/v code slabs through the
    # window-write kernel where the slab shape takes it, the small f32 scale
    # slabs (and other head dims) through the indexed write; on a sharded
    # cache the part of the window on this rank's positions, at its offsets
    slabs, news, at = (cache['k'], cache['v']), (kbuf, vbuf), seq_lens
    sslabs, snews = (), ()
    if int8_cache:
        sslabs = (cache['k_scale'], cache['v_scale'])
        snews = (ksb.transpose(2, 3), vsb.transpose(2, 3))
    if shard is not None:
        at, wins = _shard_window(slabs + sslabs, news + snews, seq_lens,
                                 None, shard)
        news, snews = tuple(wins[:2]), tuple(wins[2:])
    if _window.supports_dense(cache['k'].shape):
        _window.window_write_inplace(slabs, news, at)
    else:
        _window.window_write_plain(slabs, news, at)
    if int8_cache:
        _window.window_write_plain(sslabs, snews, at)
    return torch.stack(toks), cache


def forward(params: Params, cache: Dict[str, torch.Tensor],
            tokens: torch.Tensor, positions: torch.Tensor,
            write_pos: torch.Tensor, seq_lens: torch.Tensor,
            cfg: LlamaConfig, active: Optional[torch.Tensor] = None,
            sp_mesh=None, stages=None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B, T); positions: (B, T); write_pos/seq_lens: (B,);
    active: optional (B,) bool: False slots leave their cache untouched.
    sp_mesh: the cache holds this rank's positions of a sequence-sharded
    cache (`seq_shard`); stages: a `pipeline._Stages`, the layers and
    cache slabs this rank's stage's (`pipeline.forward_staged`).
    Returns (logits (B, T, vocab) f32, the cache, updated in place)."""
    S = cache['k'].shape[2]
    x = params['embed'][tokens.long()]
    shard = seq_shard(cache, sp_mesh, cfg)

    # causal mask over cache slots: token t (absolute pos positions[b,t])
    # attends to cache slots [0, positions[b,t]]; shape broadcasts against
    # grouped-GQA logits (B, KV, rep, T, S)
    slot_ids = torch.arange(S, device=x.device)[None, None, None, None, :]
    if shard is not None:
        slot_ids = slot_ids + shard.start
    tok_pos = positions[:, None, None, :, None]              # (B,1,1,T,1)
    causal = slot_ids <= tok_pos                             # (B,1,1,T,S)

    ks_all = cache.get('k_scale')
    vs_all = cache.get('v_scale')

    def body(x, part, rows):
        for li, layer in enumerate(params['layers']):
            x, _, _, _, _ = decoder_layer(
                layer, cache['k'][li][rows], cache['v'][li][rows],
                ks_all[li][rows] if ks_all is not None else None,
                vs_all[li][rows] if vs_all is not None else None,
                x, positions[rows], write_pos[rows], cfg, causal[rows],
                active=active[rows] if active is not None else None,
                shard=shard)
        return x
    x = _run_layers(x, body, stages)

    x = rms_norm(x, params['final_norm'], cfg.rms_eps, cfg.batch_invariant)
    logits = qmatmul(x, params['lm_head'],
                     kernel=bool(cfg.use_kernel_matmul))
    # lm_head may be padded for the kernel's tiling (fuse_decode_params)
    return logits[..., :cfg.vocab_size].to(F32), cache
