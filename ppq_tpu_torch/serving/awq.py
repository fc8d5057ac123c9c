"""Activation-aware weight quantization (AWQ) and SmoothQuant for the
serving engine: the JAX package's `ppq_tpu/serving/awq.py`.

AWQ (Lin et al., 2023) rebalances each linear group per INPUT channel
before quantizing: weights scaled up by s, activations down by 1/s, where
s = m^alpha (m: the calibration activations' channel abs-mean) and alpha
is grid-searched on the group's output reconstruction error. The 1/s folds
exactly into the rms_norm gamma that feeds the group ({wq, wk, wv} after
attn_norm, {w_gate, w_up} after mlp_norm), so it costs nothing at run time;
wo and w_down keep plain (mse) quantization. SmoothQuant (Xiao et al.,
2022) folds s_j = max|X_j|^alpha / max|W_j|^(1-alpha) the same way, for
the W8A8 path (cfg.act_bits == 8).

Everything computes on the device of the parameter tree (the card for a
tree made there), in float32 as the JAX package's numpy does: its loops over
full-width captures would take minutes on the host. Sums (channel means,
products, errors) run in the device's order, so a choice between two
alphas whose errors lie within rounding of each other may fall the other
way (tests/test_torch_awq.py states the share of codes that may differ).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from ..executor.ops.default import simulation_precision
from .config import LlamaConfig
from .model import (F32, Params, _pv_context, _qk_logits, mlp, qmatmul,
                    quantize_weight, rms_norm, rope_apply, rope_tables)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens.cpu() if isinstance(
        tokens, torch.Tensor) else tokens, np.int64), device=device)


def capture_norm_inputs(params: Params, cfg: LlamaConfig, tokens,
                        full: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Run a float forward over a (B, T) token sample and capture each
    layer's attn_norm / mlp_norm OUTPUTS (the linear groups' inputs) as
    (B*T, D) float32 tensors on the parameters' device. Causal within the
    window (prefill semantics, no cache).

    full=True also captures the wo input ('ctx': the attention context)
    and the w_down input ('act': silu(gate) * up): GPTQ needs every
    linear's input statistics."""
    device = params['embed'].device
    tok = _tokens(tokens, device)
    B, T = tok.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    caps = []
    with torch.no_grad(), simulation_precision('highest'):
        x = params['embed'][tok]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=device)[None].expand(B, T)
        r_cos, r_sin = rope_tables(positions, cfg.rope_theta, Dh)
        causal = (torch.arange(T, device=device)[None, :]
                  <= torch.arange(T, device=device)[:, None])
        for layer in params['layers']:
            h = rms_norm(x, layer['attn_norm'], cfg.rms_eps)
            cap = {'attn': h.to(F32).reshape(-1, x.shape[-1])}
            q = qmatmul(h, layer['wq']).reshape(B, T, H, Dh)
            k = qmatmul(h, layer['wk']).reshape(B, T, KV, Dh)
            v = qmatmul(h, layer['wv']).reshape(B, T, KV, Dh)
            q = rope_apply(q, r_cos, r_sin)
            k = rope_apply(k, r_cos, r_sin)
            s = _qk_logits(q.reshape(B, T, KV, rep, Dh), k)   # (B,KV,rep,T,T)
            s = torch.where(causal, s / math.sqrt(Dh), -1e30)
            p = torch.softmax(s, dim=-1)
            ctx = _pv_context(p.to(x.dtype), v)
            ctx = ctx.reshape(B, T, H * Dh).to(x.dtype)
            if full:
                cap['ctx'] = ctx.to(F32).reshape(-1, H * Dh)
            x = x + qmatmul(ctx, layer['wo'])
            h = rms_norm(x, layer['mlp_norm'], cfg.rms_eps)
            cap['mlp'] = h.to(F32).reshape(-1, x.shape[-1])
            if full:
                g = qmatmul(h, layer['w_gate'])
                u = qmatmul(h, layer['w_up'])
                act = F_.silu(g.to(F32)) * u
                cap['act'] = act.to(F32).reshape(-1, act.shape[-1])
            x = x + mlp(h, layer, cfg)
            caps.append(cap)
    return caps


def _rows(xs: torch.Tensor, max_rows: int) -> torch.Tensor:
    """At most max_rows rows, evenly spaced, as the JAX package picks them."""
    if xs.shape[0] > max_rows:
        idx = np.linspace(0, xs.shape[0] - 1, max_rows).astype(int)
        xs = xs[torch.as_tensor(idx, device=xs.device)]
    return xs


def _group_scale(xs: torch.Tensor, weights: List[torch.Tensor], bits: int,
                 alphas=(0.0, 0.25, 0.5, 0.75, 1.0),
                 max_rows: int = 512,
                 errors: Optional[list] = None) -> Tuple[torch.Tensor, float]:
    """Grid-search s = m^alpha minimizing the group's output
    reconstruction error sum_w ||(x/s) @ Q(w*s) - x @ w||^2.
    Returns (s as float32 on the device, the chosen alpha); `errors`, where
    given, receives (alpha, error) for every alpha."""
    dev = xs.device
    xs = _rows(xs.to(F32), max_rows)
    m = xs.abs().mean(dim=0) + 1e-8                       # (D,)
    m = m / torch.exp(torch.mean(torch.log(m)))           # geo-mean 1
    qm = torch.tensor(float((1 << (bits - 1)) - 1), dtype=F32, device=dev)

    def recon(w):
        sc = w.abs().amax(dim=0).clamp_min(1e-8) / qm
        return torch.clamp(torch.round(w / sc), -qm - 1, qm) * sc

    best_s, best_err, best_a = torch.ones_like(m), math.inf, 0.0
    with simulation_precision('highest'):
        refs = [xs @ w for w in weights]
        errs = []
        for a in alphas:
            s = m ** a
            err = 0.0
            for w, ref in zip(weights, refs):
                got = (xs / s) @ recon(w * s[:, None])
                err = err + torch.mean((got - ref) ** 2)
            errs.append(err)
        # one read for every alpha
        errs = torch.stack([torch.as_tensor(e, device=dev)
                            for e in errs]).cpu().tolist()
    if errors is not None:
        errors.extend(zip(alphas, errs))
    for a, err in zip(alphas, errs):
        if err < best_err:
            best_s, best_err, best_a = m ** a, err, a
    return best_s.to(F32), best_a


def _quantize_groups(params_fp: Params, cfg: LlamaConfig, caps, scale_of
                     ) -> Params:
    """Fold scale_of(group input capture, group weights) into each foldable
    group's norm gamma and quantize the group's weights scaled up by it
    (mse scales); wo / w_down and lm_head quantize plain (mse)."""
    bits = cfg.weight_bits
    out = dict(params_fp)
    layers = []
    for layer, cap in zip(params_fp['layers'], caps):
        lay = dict(layer)
        for key, gamma_key, wkeys in (
                ('attn', 'attn_norm', ('wq', 'wk', 'wv')),
                ('mlp', 'mlp_norm', ('w_gate', 'w_up'))):
            if not all(k in lay and 'w' in lay[k] for k in wkeys):
                continue
            ws = [lay[k]['w'].to(F32) for k in wkeys]
            s = scale_of(cap[key], ws)
            lay[gamma_key] = lay[gamma_key].to(F32) / s
            for k, w in zip(wkeys, ws):
                lay[k] = quantize_weight(w * s[:, None], bits, method='mse',
                                         device=w.device)
        for k in ('wo', 'w_down'):
            if k in lay and 'w' in lay[k]:
                lay[k] = quantize_weight(lay[k]['w'].to(F32), bits,
                                         method='mse',
                                         device=lay[k]['w'].device)
        layers.append(lay)
    out['layers'] = layers
    if 'w' in out['lm_head']:
        w = out['lm_head']['w']
        out['lm_head'] = quantize_weight(w.to(F32), cfg.resolved_lm_head_bits,
                                         method='mse', device=w.device)
    return out


def awq_quantize_llama_params(params_fp: Params, cfg: LlamaConfig, tokens,
                              alphas=(0.0, 0.25, 0.5, 0.75, 1.0)) -> Params:
    """AWQ-fold and quantize a FLOAT param tree (init_llama_params
    quantized=False layout: every linear is {'w': bf16}) on its device.

    tokens: (B, T) calibration sample. Returns a quantized tree in the
    engine's standard format (scales folded into the norm gammas; wo /
    w_down use plain mse quantization)."""
    caps = capture_norm_inputs(params_fp, cfg, tokens)
    return _quantize_groups(
        params_fp, cfg, caps,
        lambda xs, ws: _group_scale(xs, ws, cfg.weight_bits, alphas)[0])


def smoothquant_scale(xs: torch.Tensor, ws: List[torch.Tensor],
                      alpha: float = 0.5) -> torch.Tensor:
    """s_j = max|X_j|^alpha / max|W_j|^(1-alpha), normalised to geo-mean 1
    and floored at 1e-4."""
    x_max = xs.abs().amax(dim=0) + 1e-8                          # (D,)
    w_max = torch.stack([w.abs().amax(dim=1) for w in ws]).amax(dim=0) \
        + 1e-8                                                   # (D,)
    s = (x_max ** alpha) / (w_max ** (1.0 - alpha))
    return torch.clamp_min(s / torch.exp(torch.mean(torch.log(s))), 1e-4)


def smoothquant_llama_params(params_fp: Params, cfg: LlamaConfig, tokens,
                             alpha: float = 0.5) -> Params:
    """SmoothQuant for the W8A8 path (cfg.act_bits == 8): migrate activation
    outliers into the weights, folded exactly into the preceding rms_norm
    gamma (the same zero-cost fold as AWQ; the objective balances activation
    quantization difficulty against weight quantization). Weights then
    quantize with the mse scale search; wo / w_down quantize plain."""
    caps = capture_norm_inputs(params_fp, cfg, tokens)
    return _quantize_groups(params_fp, cfg, caps,
                            lambda xs, ws: smoothquant_scale(xs, ws, alpha))
