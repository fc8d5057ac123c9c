"""Mixture-of-Experts FFN: the JAX package's `ppq_tpu/serving/moe.py` on one
card.

A top-k routed MoE FFN in the dense-einsum formulation: the experts stay as
one stacked (E, d, f) tensor, every expert runs on every token, and the
router's top-k weights (renormalised to sum 1) combine the expert outputs.
Expert weights use the dense path's INT8 per-channel weight-only format
(scales per (expert, out-channel)).

On a mesh the expert stacks split over 'ep' (or 'tp'):
`shard_moe_params` gives a rank its experts as an ExpertParallel dict
(serving/tensor_parallel.py), and `moe_ffn` sums the ranks' shares with an
all-reduce. MoE on a 'pp' mesh raises, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F_

from ..executor.executor import resolve_device
from ..parallel.multihost import all_reduce
from .tensor_parallel import ExpertParallel
from .tensor_parallel import shard_moe_params  # noqa: F401  (the API's)

BF16, F32 = torch.bfloat16, torch.float32


def init_moe_params(d_model: int, d_ff: int, n_experts: int, top_k: int = 2,
                    weight_bits: int = 8, seed: int = 0, device=None) -> Dict:
    """Router and expert stacks on `device` (the card unless named), drawn
    with numpy in the JAX package's order, so a seed means the same weights
    in both packages. The stacks are quantized on the device, with the
    same IEEE float32 division and rounding as numpy's."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def stack(i, o):
        w = rng.standard_normal((n_experts, i, o), dtype=np.float32) \
            * np.float32(1.0 / np.sqrt(i))
        wt = torch.from_numpy(w).to(device)
        if weight_bits >= 16:
            return {'w': wt.to(BF16)}
        qmax = (1 << (weight_bits - 1)) - 1
        # tensor divisors: a Python scalar would become a multiplication by
        # its reciprocal on the card
        absmax = wt.abs().amax(dim=1).clamp_min(1e-8)            # (E, o)
        scale = absmax / torch.tensor(float(qmax), dtype=F32, device=device)
        q = torch.round(wt / scale[:, None, :]).clamp(-qmax - 1, qmax)
        return {'w_int': q.to(torch.int8), 'scale': scale}

    router = rng.standard_normal((d_model, n_experts), dtype=np.float32) \
        * 0.02
    return {
        'router': torch.from_numpy(router).to(device),
        'w_gate': stack(d_model, d_ff),
        'w_up': stack(d_model, d_ff),
        'w_down': stack(d_ff, d_model),
        'top_k': top_k,              # python ints, as in the JAX package
        'n_experts': n_experts,
    }


def _deq(wq) -> torch.Tensor:
    if 'w' in wq:
        return wq['w'].to(F32)
    return wq['w_int'].to(F32) * wq['scale'][:, None, :].to(F32)


def top_k_lower_index(x: torch.Tensor, k: int):
    """The k largest values of the last axis and their indices, a tie
    taken by the lower index, as `lax.top_k` takes it (a stable descending
    sort; recorded difference 37 for the TopK op)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_ffn(x: torch.Tensor, params: Dict,
            top_k: Optional[int] = None) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D). Dense-einsum top-k MoE in float32: every
    expert for every token, combined with the renormalised top-k router
    weights (zeros off the top k). On a rank of an expert-parallel mesh
    (an ExpertParallel `params`) the rank's experts only, their share
    all-reduced in float32."""
    k = int(top_k if top_k is not None else params['top_k'])
    xf = x.to(F32)
    logits = torch.einsum('btd,de->bte', xf, params['router'].to(F32))
    gates = torch.softmax(logits, dim=-1)                    # (B, T, E)
    top_w, top_i = top_k_lower_index(gates, k)               # (B, T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    combine = torch.zeros_like(gates).scatter(-1, top_i, top_w)
    sharded = isinstance(params, ExpertParallel)
    if sharded:
        e_local = params['w_gate'][next(iter(params['w_gate']))].shape[0]
        combine = combine[..., params.offset:params.offset + e_local]

    wg, wu, wd = (_deq(params['w_gate']), _deq(params['w_up']),
                  _deq(params['w_down']))
    g = torch.einsum('btd,edf->betf', xf, wg)
    u = torch.einsum('btd,edf->betf', xf, wu)
    h = F_.silu(g) * u                                       # (B, E, T, F)
    y = torch.einsum('betf,efd->betd', h, wd)                # (B, E, T, D)
    out = torch.einsum('betd,bte->btd', y, combine)
    if sharded:
        out = all_reduce(out.contiguous(), params.group)
    return out.to(x.dtype)
