"""Ring attention: sequence-parallel attention over a mesh axis.

Counterpart of `ppq_tpu/serving/ring_attention.py`. When a sequence is
sharded over the 'sp' axis, exact (causal or full) attention rotates the
K/V blocks around the ring, `ring_shift` (a `batch_isend_irecv` to the next
rank and from the previous one, `jax.lax.ppermute`'s counterpart), while
each rank accumulates a flash-style online softmax of its query block.
All math runs in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.multihost import ring_shift

F32 = torch.float32


def _ring_attention_local(q, k, v, group, index: int, n_dev: int,
                          scale: float, causal: bool):
    """One rank's part. q, k, v: (B, Tc, H, Dh) local sequence chunks.
    Returns (B, Tc, H, Dh)."""
    B, Tc, H, Dh = q.shape
    dev = q.device
    qf = q.to(F32).transpose(1, 2)                        # (B, H, Tc, Dh)
    m = torch.full((B, H, Tc, 1), -math.inf, dtype=F32, device=dev)
    l = torch.zeros((B, H, Tc, 1), dtype=F32, device=dev)
    o = torch.zeros((B, H, Tc, Dh), dtype=F32, device=dev)
    q_pos = index * Tc + torch.arange(Tc, device=dev)      # global positions
    k_blk, v_blk = k, v
    for step in range(n_dev):
        # the block held now came from rank (index - step) % n
        src = (index - step) % n_dev
        k_pos = src * Tc + torch.arange(Tc, device=dev)
        kf = k_blk.to(F32).transpose(1, 2)
        vf = v_blk.to(F32).transpose(1, 2)
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]        # (Tc, Tc)
            logits = torch.where(mask, logits, -math.inf)
        blk_max = logits.amax(-1, keepdim=True)
        m_new = torch.maximum(m, blk_max)
        # fully-masked blocks produce -inf maxima; guard the exp
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(torch.where(torch.isfinite(logits), logits - m_safe,
                                  -math.inf))
        p = torch.where(torch.isfinite(p), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.matmul(p, vf)
        m = m_new
        if step + 1 < n_dev:
            # rotate K/V one step around the ring (rank i -> i + 1)
            k_blk, v_blk = ring_shift([k_blk, v_blk], group)
    out = o / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                # (B, Tc, H, Dh)


def sequence_parallel_attention(q, k, v, mesh, axis_name: str = 'sp',
                                scale: Optional[float] = None,
                                causal: bool = True):
    """Exact (ring) attention with the sequence dim sharded over
    `axis_name`. q, k, v: this rank's (B, T / n, H, Dh) chunks of the
    global sequence, the axis's i-th rank holding the i-th chunk. Returns
    this rank's (B, T / n, H, Dh) chunk of the output."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = mesh.shape.get(axis_name, 1)
    return _ring_attention_local(q, k, v, mesh.group(axis_name),
                                 mesh.index(axis_name), n, scale, causal)


def reference_attention(q, k, v, scale: Optional[float] = None,
                        causal: bool = True):
    """Dense single-device reference for testing."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.to(F32).transpose(1, 2)
    kf = k.to(F32).transpose(1, 2)
    vf = v.to(F32).transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, vf)
    return out.transpose(1, 2).to(q.dtype)
