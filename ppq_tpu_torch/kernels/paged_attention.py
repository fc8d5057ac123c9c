"""Ragged decode attention over the int8 (or bf16) KV cache: the CUDA
kernels' wrappers, their plain versions and the layout glue around them.

Counterpart of ppq_tpu/kernels/paged_attention.py
`paged_attention_decode_fused` (`_make_kernel`),
`paged_attention_decode_grouped` (`_make_grouped_kernel`) and
`paged_attention_decode_buffered` (`_make_buffered_kernel`), with
`identity_block_tables`, `blockmajor_window`, `grouped_group_size`,
`merge_attention` and `paged_attention_reference`. The kernels are
`ppq_tpu_torch/csrc/paged_attention.cu`; its source says what bounds them on
the card and what stands there for the TPU's block-diagonal query and slot
grouping (neither is carried over).

Both return the unnormalised online-softmax triple (acc, m, l) of one decode
step, per slot b, KV head h and query row r, over the slot's filled
positions t < seq_lens[b], block by block:

    s[t] = (q_bf16 . k_code, f32 sum) * k_scale[t] * (1 / sqrt(Dh))
    m'   = max(m, max_t s);   corr = exp(m - m')
    p[t] = exp(s[t] - m');    l = l * corr + sum_t p[t]
    acc  = acc * corr + sum_t bf16(p[t] * v_scale[t]) * v_code[t]   (f32)

`acc / l` is the attention output when there is nothing to merge
(`merge_attention`). A slot with seq_lens == 0 returns m = -1e30, l = 0 and
acc = 0; the JAX kernel leaves acc undefined there, the port defines it. The
plain versions repeat this arithmetic block by block; the kernel updates
the running max once a stage of 16 positions in each of the one or two
warps of a (slot, KV head) and merges the warps at the end, so the two
differ in the order of f32 sums, in the last bit of exp and in where
p * v_scale rounds to bf16 (against another running max), within the
attention tolerance.

A seq_lens entry outside [0, MB * BLK] is clamped there; a block-table row
outside the pool is read as an empty block. On the card the kernel also sets
a bit of the device's fault word (`loader.read_faults`).

The buffered read (row 13) runs the same online softmax over the slot's
filled pool blocks and then over the in-burst buffer's columns [0, step] as
one more block, and returns acc / max(l, 1e-30). Its values take the TPU
kernel's numerics: v_eff = bf16(v_code * bf16(v_scale)), and p rounds to
bf16 alone (rows 11 and 12 round bf16(p * v_scale) instead). The plain
version updates once a pool block and once for the buffer; the kernel walks
the pool's positions, then the buffer's columns, in stages of 16 positions
a warp as rows 11 and 12 do, so the two differ in the same ways.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .loader import LAUNCHES, check, fault_word, library, stream_of

NEG_INF = -1e30
F32, BF16 = torch.float32, torch.bfloat16

# what the kernel takes (csrc/paged_attention.cu)
KERNEL_HEAD_DIM = 128
KERNEL_REPS = (1, 2, 4)
KERNEL_MAX_BLOCK = 2048


# ------------------------------------------------------------ host glue ----

def identity_block_tables(B: int, S: int, block_size: int = 128,
                          device=None) -> torch.Tensor:
    """Block tables mapping each slot's logical blocks to its own rows of
    the reshaped contiguous cache ((B, S, ...) -> (B*S/BLK, BLK, ...)).
    On the card unless `device` names another; without a card and without a
    named device this raises, like every entry point of the port."""
    from ..executor.executor import resolve_device
    device = resolve_device(device)
    MB = S // block_size
    return (torch.arange(B, dtype=torch.int32, device=device)[:, None] * MB
            + torch.arange(MB, dtype=torch.int32, device=device)[None, :])


def _window(cache_k, cache_v, cache_ks, cache_vs, cap, blk, block_major):
    """Repack the window [0, cap) of a contiguous cache into a fused pool:
    kv (NBp*B, 2, BLK, KV*Dh) and scales (NBp*B, 2, KV, SCP) (or None), an
    L axis leading when the cache has one. Row j*B + b holds slot b's block
    j when block_major, row b*NBp + j otherwise. One strided copy a plane,
    into tensors allocated once."""
    layered = cache_k.dim() == 5
    if not layered:
        cache_k, cache_v = cache_k[None], cache_v[None]
        if cache_ks is not None:
            cache_ks, cache_vs = cache_ks[None], cache_vs[None]
    L, B, _, KV, Dh = cache_k.shape
    nbp = cap // blk
    dev = cache_k.device

    def blocks(t, width):
        # (L, B, cap, ...) -> (L, NBp, B, blk, width) or (L, B, NBp, blk, width)
        t = t[:, :, :cap].reshape(L, B, nbp, blk, width)
        return t.transpose(1, 2) if block_major else t

    kv = torch.empty((L, nbp * B, 2, blk, KV * Dh), dtype=cache_k.dtype,
                     device=dev)
    lead = (L, nbp, B) if block_major else (L, B, nbp)
    view = kv.view(*lead, *kv.shape[2:])
    view[:, :, :, 0].copy_(blocks(cache_k, KV * Dh))
    view[:, :, :, 1].copy_(blocks(cache_v, KV * Dh))
    sc = None
    if cache_ks is not None:
        # lane-padded to 128 columns in the grouped layout, as the JAX
        # package pads it for its TPU kernel; the kernels read [:blk]
        scp = max(blk, 128) if block_major else blk
        alloc = torch.zeros if scp > blk else torch.empty
        sc = alloc((L, nbp * B, 2, KV, scp), dtype=cache_ks.dtype, device=dev)
        sview = sc.view(*lead, *sc.shape[2:])
        sview[:, :, :, 0, :, :blk].copy_(blocks(cache_ks, KV).transpose(-1, -2))
        sview[:, :, :, 1, :, :blk].copy_(blocks(cache_vs, KV).transpose(-1, -2))
    if not layered:
        kv = kv[0]
        sc = None if sc is None else sc[0]
    return kv, sc


def blockmajor_window(cache_k, cache_v, cache_ks, cache_vs, cap: int,
                      blk: int):
    """The grouped kernel's BLOCK-MAJOR fused layout of the cache window
    [0, cap): kv (NBp*B, 2, BLK, KV*Dh), pool row j*B + b holding slot b's
    block j; scales (NBp*B, 2, KV, max(BLK, 128)) or None. Takes one layer's
    (B, S, KV, Dh) slabs or the stacked (L, B, S, KV, Dh) cache (the outputs
    then gain an L axis, which the kernels index with `layer=`). A copy of
    the window: callers make it once per burst."""
    return _window(cache_k, cache_v, cache_ks, cache_vs, cap, blk, True)


def slotmajor_window(cache_k, cache_v, cache_ks, cache_vs, cap: int,
                     blk: int):
    """The fused kernel's layout of the cache window [0, cap) under
    `identity_block_tables`: pool row b*NBp + j holds slot b's block j,
    scales (NBp*B, 2, KV, BLK). The JAX package builds it inline in
    `burst_forward`; a copy of the window, once per burst."""
    return _window(cache_k, cache_v, cache_ks, cache_vs, cap, blk, False)


def grouped_group_size(batch: int, block_size: int, kv_dh: int = 1024,
                       itemsize: int = 1, n_heads: int = 16) -> int:
    """The JAX package's G: the largest power of two up to 64 dividing batch
    whose per-group working set fits 11 MiB of TPU memory. Kept as it is so
    that both packages group alike; on the card G only sets which slots
    share a loop bound."""
    budget = 11 * 1024 * 1024
    per_slot = (2 * 2 * block_size * kv_dh * itemsize
                + n_heads * kv_dh * (4 + 2))
    g = 64
    while g > 1 and (batch % g or g * per_slot > budget):
        g //= 2
    return g


def merge_attention(parts):
    """Merge [(acc, m, l), ...] partial-softmax triples exactly: softmax
    over the concatenation of all score sets. Returns the normalised
    context (..., Dh) f32."""
    accs, ms, ls = zip(*parts)
    m = functools.reduce(torch.maximum, ms)
    # each weight once, and no scalar 0 to start the sums: the JAX package's
    # values with fewer launches (a decode step merges once a layer)
    ws = [torch.exp(mi - m) for mi in ms]
    acc = functools.reduce(torch.add, [a * w[..., None] for a, w in zip(accs, ws)])
    l = functools.reduce(torch.add, [li * w for li, w in zip(ls, ws)])
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def paged_attention_reference(q, k_pool, v_pool, k_scale, v_scale,
                              block_tables, seq_lens, *, block_size=128):
    """Dense twin of the kernels over separate pools (NB, BLK, KV*Dh) and
    scales (NB, KV, BLK): one softmax in f32, p not rounded."""
    B, KV, rep, Dh = q.shape
    MB = block_tables.shape[1]
    S = MB * block_size
    tbl = block_tables.long()
    k = k_pool[tbl].reshape(B, S, KV, Dh).to(F32)
    v = v_pool[tbl].reshape(B, S, KV, Dh).to(F32)
    s = torch.einsum('bkrd,bskd->bkrs', q.to(F32), k)
    if k_scale is not None:
        ks = k_scale[tbl].transpose(1, 2).reshape(B, KV, S)
        s = s * ks[:, :, None, :]
    s = s / np.sqrt(Dh)
    mask = torch.arange(S, device=q.device)[None, :] < seq_lens[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    if v_scale is not None:
        vs = v_scale[tbl].transpose(1, 2).reshape(B, KV, S)
        p = p * vs[:, :, None, :]
    return torch.einsum('bkrs,bskd->bkrd', p, v), m, l


# -------------------------------------------------------- plain versions ----

def _inv_sqrt(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def _online_update(qf, state, k, v, ks, vs, mask, live, fold_v=False):
    """One block of the kernels' online softmax: state (acc, m, l) -> the
    new state, rows where `live` is False unchanged. k, v: (B, BLK, KV, Dh)
    f32; ks, vs: (B, KV, BLK) or None; mask: (B, 1, 1, BLK). fold_v: row
    13's numerics (v_scale rounded to bf16 and folded into the values, p
    rounded to bf16 alone), else rows 11 and 12's (bf16(p * v_scale))."""
    acc, m, l = state
    inv_sqrt = torch.tensor(_inv_sqrt(qf.shape[-1]), dtype=F32,
                            device=qf.device)
    s = torch.einsum('bkrd,btkd->bkrt', qf, k)
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = torch.where(mask, s * inv_sqrt, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * corr + p.sum(-1)
    if fold_v:
        if vs is not None:
            v = (v * vs.to(BF16).to(F32).transpose(1, 2)[..., None]) \
                .to(BF16).to(F32)
    elif vs is not None:
        p = p * vs[:, :, None, :]
    pv = torch.einsum('bkrt,btkd->bkrd', p.to(BF16).to(F32), v)
    acc_new = acc * corr[..., None] + pv
    keep = live[:, None, None]
    return (torch.where(keep[..., None], acc_new, acc),
            torch.where(keep, m_new, m), torch.where(keep, l_new, l))


def _online(q, lens, n_blocks, blk, fetch, fold_v=False, state=None):
    """The kernels' arithmetic, block by block. fetch(j) -> (ok (B,) bool,
    k, v (B, BLK, KV, Dh) f32, ks, vs (B, KV, BLK) f32 or None). Starts from
    `state` (acc, m, l) or the empty one."""
    B, KV, rep, Dh = q.shape
    dev = q.device
    qf = q.to(BF16).to(F32)
    if state is None:
        state = (torch.zeros((B, KV, rep, Dh), dtype=F32, device=dev),
                 torch.full((B, KV, rep), NEG_INF, dtype=F32, device=dev),
                 torch.zeros((B, KV, rep), dtype=F32, device=dev))
    lanes = torch.arange(blk, device=dev)[None, :]
    for j in range(n_blocks):
        nv = lens - j * blk
        live = nv > 0
        if not bool(live.any()):
            continue
        ok, k, v, ks, vs = fetch(j)
        mask = (lanes < nv[:, None])[:, None, None, :]        # (B,1,1,BLK)
        state = _online_update(qf, state, k, v, ks, vs, mask, live & ok,
                               fold_v)
    return state


def _slab(t, layer):
    """One layer's slab of a layered pool (a view)."""
    if t is None:
        return None
    if layer is None:
        raise ValueError('a layered pool needs a layer index')
    return t[int(layer)]


def paged_attention_decode_fused_plain(q, kv_pool, kv_scale, block_tables,
                                       seq_lens, layer=None, *,
                                       block_size: int = 128):
    """Row 11's arithmetic in plain PyTorch, on any device."""
    if kv_pool.dim() == 5:
        kv_pool, kv_scale = _slab(kv_pool, layer), _slab(kv_scale, layer)
    B, KV, rep, Dh = q.shape
    NB, _, BLK, _ = kv_pool.shape
    MB = block_tables.shape[1]
    lens = seq_lens.to(torch.int64).clamp(0, MB * BLK)
    tables = block_tables.to(torch.int64)

    def fetch(j):
        rows = tables[:, j]
        ok = (rows >= 0) & (rows < NB)
        rows = rows.clamp(0, NB - 1)
        blk = kv_pool[rows].to(F32)                   # (B, 2, BLK, KV*Dh)
        k = blk[:, 0].reshape(B, BLK, KV, Dh)
        v = blk[:, 1].reshape(B, BLK, KV, Dh)
        if kv_scale is None:
            return ok, k, v, None, None
        sc = kv_scale[rows]                           # (B, 2, KV, BLK)
        return ok, k, v, sc[:, 0], sc[:, 1]
    return _online(q, lens, MB, BLK, fetch)


def paged_attention_decode_grouped_plain(q, kv_bm, sc_bm, seq_lens,
                                         layer=None, *, block_size: int,
                                         group: int):
    """Row 12's arithmetic in plain PyTorch, on any device. A block past a
    slot's own fill but inside its group's is all masked: a no-op, so the
    plain version does not walk it."""
    if kv_bm.dim() == 5:
        kv_bm, sc_bm = _slab(kv_bm, layer), _slab(sc_bm, layer)
    B, KV, rep, Dh = q.shape
    NBtot, _, BLK, _ = kv_bm.shape
    MB = NBtot // B
    lens = seq_lens.to(torch.int64).clamp(0, MB * BLK)
    ok = torch.ones(B, dtype=torch.bool, device=q.device)

    def fetch(j):
        blk = kv_bm[j * B:(j + 1) * B].to(F32)
        k = blk[:, 0].reshape(B, BLK, KV, Dh)
        v = blk[:, 1].reshape(B, BLK, KV, Dh)
        if sc_bm is None:
            return ok, k, v, None, None
        sc = sc_bm[j * B:(j + 1) * B, :, :, :BLK]
        return ok, k, v, sc[:, 0], sc[:, 1]
    return _online(q, lens, MB, BLK, fetch)


# -------------------------------------------------------------- kernels ----

def _check_common(what, q, pool, scale, seq_lens, layer):
    if q.dim() != 4:
        raise ValueError(f'{what} takes q as (B, KV, rep, Dh)')
    B, KV, rep, Dh = q.shape
    if pool.dim() == 5:
        if layer is None:
            raise ValueError(f'{what}: a layered pool needs a layer index')
        if not 0 <= int(layer) < pool.shape[0]:
            raise ValueError(f'{what}: layer {int(layer)} outside '
                             f'{pool.shape[0]} layers')
    elif pool.dim() != 4:
        raise ValueError(f'{what} takes a pool (L?, NB, 2, BLK, KV*Dh)')
    if pool.shape[-3] != 2 or pool.shape[-1] != KV * Dh:
        raise ValueError(f'{what}: pool {tuple(pool.shape)} against q '
                         f'{tuple(q.shape)}')
    if pool.dtype not in (torch.int8, BF16):
        raise TypeError(f'{what} reads an int8 or bfloat16 pool')
    if scale is not None and (scale.dtype != F32
                              or scale.dim() != pool.dim()):
        raise TypeError(f'{what} takes float32 scales shaped like the pool')
    if seq_lens.shape != (B,):
        raise ValueError(f'{what}: seq_lens {tuple(seq_lens.shape)} for '
                         f'{B} slots')


def _launch(what, q, pool, scale, tables, seq_lens, layer, MB, NB, SCP,
            group):
    """Checks what only the kernel needs, then launches (`_run`). Raises on
    whatever the kernel does not take, before anything reaches the card."""
    B, KV, rep, Dh = q.shape
    BLK = pool.shape[-2]
    if Dh != KERNEL_HEAD_DIM or rep not in KERNEL_REPS:
        raise ValueError(f'{what}: the kernel takes head dim '
                         f'{KERNEL_HEAD_DIM} and {KERNEL_REPS} query heads '
                         f'per KV head, not {Dh} and {rep}')
    if BLK % 16 or BLK > KERNEL_MAX_BLOCK:
        raise ValueError(f'{what}: block size {BLK} (the kernel takes a '
                         f'multiple of 16 up to {KERNEL_MAX_BLOCK})')
    tensors = [pool, seq_lens] + [t for t in (scale, tables) if t is not None]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f'{what} takes contiguous tensors on {q.device}')
    if seq_lens.dtype != torch.int32 or (
            tables is not None and tables.dtype != torch.int32):
        raise TypeError(f'{what} takes int32 seq_lens and block tables')
    if pool.dim() == 5:
        pool = pool[int(layer)]
        scale = None if scale is None else scale[int(layer)]
    q = q.to(BF16).contiguous()
    if any(t.data_ptr() % 16 for t in (q, pool, scale) if t is not None):
        raise ValueError(f'{what} takes 16-byte aligned q, pool and scales')
    return _run(what, q, pool, scale, tables, seq_lens, MB, NB, SCP, group)


def _run(what, q, pool, scale, tables, seq_lens, MB, NB, SCP, group):
    """Allocates the outputs and launches the kernel on checked inputs."""
    B, KV, rep, Dh = q.shape
    acc = torch.empty((B, KV, rep, Dh), dtype=F32, device=q.device)
    m = torch.empty((B, KV, rep), dtype=F32, device=q.device)
    l = torch.empty((B, KV, rep), dtype=F32, device=q.device)
    lib = library('paged_attention')
    with torch.cuda.device(q.device):
        rc = lib.ppq_paged_attention(
            q.data_ptr(), pool.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if tables is None else tables.data_ptr(),
            seq_lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            fault_word(q.device).data_ptr(), int(pool.dtype == BF16), B, KV,
            rep, Dh, MB, NB, pool.shape[-2], SCP, group, _inv_sqrt(Dh),
            stream_of(q.device))
    check(rc, what)
    LAUNCHES[what] += 1
    return acc, m, l


def paged_attention_decode_fused(q: torch.Tensor, kv_pool: torch.Tensor,
                                 kv_scale: Optional[torch.Tensor],
                                 block_tables: torch.Tensor,
                                 seq_lens: torch.Tensor, layer=None, *,
                                 block_size: int = 128):
    """One decode step of attention over a FUSED paged pool.

    q:        (B, KV, rep, Dh), grouped query heads after rope
    kv_pool:  (NB, 2, BLK, KV*Dh) int8 | bf16, [k; v] per pool row; or
              (L, NB, 2, BLK, KV*Dh) with `layer` (an int) naming the slab
    kv_scale: (NB, 2, KV, BLK) f32 (L-leading with the pool), or None
    block_tables: (B, MB) int32, the pool row of each logical block
    seq_lens: (B,) int32, tokens in each sequence

    Returns (acc (B, KV, rep, Dh), m, l (B, KV, rep)), all f32. CPU tensors
    take the plain version; CUDA tensors the kernel, or a ValueError for
    shapes it does not take."""
    what = 'paged_attention_fused'
    _check_common(what, q, kv_pool, kv_scale, seq_lens, layer)
    BLK = kv_pool.shape[-2]
    if BLK != block_size or block_tables.dim() != 2 \
            or block_tables.shape[0] != q.shape[0]:
        raise ValueError(f'{what}: block size {block_size}, pool blocks of '
                         f'{BLK}, tables {tuple(block_tables.shape)}')
    if q.device.type == 'cpu':
        return paged_attention_decode_fused_plain(
            q, kv_pool, kv_scale, block_tables, seq_lens, layer,
            block_size=block_size)
    if q.device.type != 'cuda':
        raise ValueError(f'{what} runs on cpu or cuda, not {q.device}')
    return _launch(what, q, kv_pool, kv_scale, block_tables, seq_lens, layer,
                   block_tables.shape[1], kv_pool.shape[-4], BLK, 0)


def paged_attention_decode_grouped(q: torch.Tensor, kv_bm: torch.Tensor,
                                   sc_bm: Optional[torch.Tensor],
                                   seq_lens: torch.Tensor, layer=None, *,
                                   block_size: int, group: int):
    """The same (acc, m, l) over a BLOCK-MAJOR window (`blockmajor_window`:
    pool row j*B + b is slot b's block j; scales lane-padded to
    max(BLK, 128)), `group` slots sharing the loop bound of their deepest
    fill, each masking its own surplus. kv_bm may carry an L axis with
    `layer`. CPU tensors take the plain version; CUDA tensors the kernel."""
    what = 'paged_attention_grouped'
    _check_common(what, q, kv_bm, sc_bm, seq_lens, layer)
    B = q.shape[0]
    NBtot, BLK = kv_bm.shape[-4], kv_bm.shape[-2]
    SCP = max(BLK, 128)
    if BLK != block_size or group < 1 or B % group or NBtot % B:
        raise ValueError(f'{what}: {B} slots in groups of {group}, '
                         f'{NBtot} pool rows of {BLK} (block size '
                         f'{block_size})')
    if sc_bm is not None and sc_bm.shape[-1] != SCP:
        raise ValueError(f'{what}: scales padded to {sc_bm.shape[-1]} '
                         f'columns, not {SCP}')
    if q.device.type == 'cpu':
        return paged_attention_decode_grouped_plain(
            q, kv_bm, sc_bm, seq_lens, layer, block_size=block_size,
            group=group)
    if q.device.type != 'cuda':
        raise ValueError(f'{what} runs on cpu or cuda, not {q.device}')
    return _launch(what, q, kv_bm, sc_bm, None, seq_lens, layer,
                   NBtot // B, NBtot, SCP, group)


# -------------------------------------------- row 13: pool + buffer ----

def paged_attention_decode_buffered_plain(q, k_pool, v_pool, k_scale,
                                          v_scale, block_tables, seq_lens,
                                          kbuf, vbuf, ks_buf, vs_buf, step,
                                          *, block_size: int = 128):
    """Row 13's arithmetic in plain PyTorch, on any device: the slot's
    filled pool blocks, then buffer columns [0, step] as one more block, in
    one online softmax with the v scale folded into the values; returns the
    normalised context."""
    B, KV, rep, Dh = q.shape
    NB, BLK, _ = k_pool.shape
    MB = block_tables.shape[1]
    nbuf = kbuf.shape[1]
    lens = seq_lens.to(torch.int64).clamp(0, MB * BLK)
    tables = block_tables.to(torch.int64)

    def fetch(j):
        rows = tables[:, j]
        ok = (rows >= 0) & (rows < NB)
        rows = rows.clamp(0, NB - 1)
        k = k_pool[rows].to(F32).reshape(B, BLK, KV, Dh)
        v = v_pool[rows].to(F32).reshape(B, BLK, KV, Dh)
        if k_scale is None:
            return ok, k, v, None, None
        return ok, k, v, k_scale[rows], v_scale[rows]
    state = _online(q, lens, MB, BLK, fetch, fold_v=True)
    cols = torch.full((B,), min(int(step) + 1, nbuf), dtype=torch.int64,
                      device=q.device)

    def fetch_buffer(_):
        ok = torch.ones(B, dtype=torch.bool, device=q.device)
        return (ok, kbuf.to(F32).reshape(B, nbuf, KV, Dh),
                vbuf.to(F32).reshape(B, nbuf, KV, Dh), ks_buf, vs_buf)
    acc, _, l = _online(q, cols, 1, nbuf, fetch_buffer, fold_v=True,
                        state=state)
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def _rows_view(t, what, rank, device):
    """t's element stride along its leading axis, after checking that it is
    a view whose last `rank` dimensions are dense."""
    if t.device != device:
        raise ValueError(f'{what} lies on {t.device}, not {device}')
    dense = t[(0,) * (t.dim() - rank)]
    if not dense.is_contiguous():
        raise ValueError(f'{what} must be dense below its leading axis')
    return t.stride(0)


def paged_attention_decode_buffered(q: torch.Tensor, k_pool: torch.Tensor,
                                    v_pool: torch.Tensor,
                                    k_scale: Optional[torch.Tensor],
                                    v_scale: Optional[torch.Tensor],
                                    block_tables: torch.Tensor,
                                    seq_lens: torch.Tensor,
                                    kbuf: torch.Tensor, vbuf: torch.Tensor,
                                    ks_buf: Optional[torch.Tensor],
                                    vs_buf: Optional[torch.Tensor],
                                    step: int, *, block_size: int = 128):
    """Decode attention over the frozen pool AND the in-burst buffer in one
    online softmax, the context normalised.

    q:        (B, KV, rep, Dh) grouped query heads after rope
    k_pool, v_pool: (NB, BLK, KV*Dh) int8 | bf16; views with any block
              stride (`pools['kv'][layer, :, 0]` and `[:, 1]`) pass as they
              are
    k_scale, v_scale: (NB, KV, BLK) f32 (views likewise), or None
    block_tables: (B, MB) int32; seq_lens: (B,) int32
    kbuf, vbuf: (B, n, KV*Dh) of the pool's type, any slot stride
    ks_buf, vs_buf: (B, KV, n) f32, any slot stride, or None
    step: buffer columns [0, step] are valid (0 <= step)

    Returns ctx (B, KV, rep, Dh) f32. CPU tensors take the plain version;
    CUDA tensors the kernel, or a ValueError for what it does not take:
    besides head dim, rep and types, blocks a multiple of 16 up to
    KERNEL_MAX_BLOCK (a pass never crosses a block), buffers of at most
    KERNEL_MAX_BLOCK columns, codes and their strides 16-byte aligned, and
    with scales: scales and their strides 16-byte aligned and a buffer
    width that is a multiple of 4 (4 positions' scales are one 16-byte
    copy)."""
    what = 'paged_attention_buffered'
    B, KV, rep, Dh = q.shape
    NB, BLK, KVDh = k_pool.shape
    MB = block_tables.shape[1]
    nbuf = kbuf.shape[1]
    step = int(step)
    int8 = k_scale is not None
    if KVDh != KV * Dh or BLK != block_size or v_pool.shape != k_pool.shape \
            or kbuf.shape != (B, nbuf, KVDh) or vbuf.shape != kbuf.shape \
            or block_tables.shape != (B, MB) or seq_lens.shape != (B,) \
            or step < 0:
        raise ValueError(f'{what}: q {tuple(q.shape)}, pools '
                         f'{tuple(k_pool.shape)}, buffers {tuple(kbuf.shape)}, '
                         f'tables {tuple(block_tables.shape)}, step {step}')
    if int8 != (v_scale is not None) or int8 != (ks_buf is not None) \
            or int8 != (vs_buf is not None):
        raise ValueError(f'{what} takes all four scales or none')
    if int8 and (k_scale.shape != (NB, KV, BLK) or v_scale.shape != (NB, KV, BLK)
                 or ks_buf.shape != (B, KV, nbuf)
                 or vs_buf.shape != (B, KV, nbuf)):
        raise ValueError(f'{what}: scales {tuple(k_scale.shape)}, buffer '
                         f'scales {tuple(ks_buf.shape)}')
    if q.device.type == 'cpu':
        return paged_attention_decode_buffered_plain(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens,
            kbuf, vbuf, ks_buf, vs_buf, step, block_size=block_size)
    if q.device.type != 'cuda':
        raise ValueError(f'{what} runs on cpu or cuda, not {q.device}')
    if Dh != KERNEL_HEAD_DIM or rep not in KERNEL_REPS:
        raise ValueError(f'{what}: the kernel takes head dim '
                         f'{KERNEL_HEAD_DIM} and {KERNEL_REPS} query heads '
                         f'per KV head, not {Dh} and {rep}')
    if BLK % 16 or BLK > KERNEL_MAX_BLOCK:
        raise ValueError(f'{what}: block size {BLK} (the kernel takes a '
                         f'multiple of 16 up to {KERNEL_MAX_BLOCK})')
    if nbuf > KERNEL_MAX_BLOCK or (int8 and nbuf % 4):
        raise ValueError(f'{what}: buffer width {nbuf} (the kernel takes up '
                         f'to {KERNEL_MAX_BLOCK} columns, with scales a '
                         f'multiple of 4)')
    if k_pool.dtype not in (torch.int8, BF16) or v_pool.dtype != k_pool.dtype \
            or kbuf.dtype != k_pool.dtype or vbuf.dtype != k_pool.dtype:
        raise TypeError(f'{what} reads int8 or bfloat16 pools and buffers of '
                        f'one type')
    dev = q.device
    codes = (k_pool, v_pool, kbuf, vbuf)
    strides = [_rows_view(t, what, 2, dev) for t in codes]
    if any(t.data_ptr() % 16 or t.stride(0) * t.element_size() % 16
           for t in codes) or KVDh * k_pool.element_size() % 16:
        raise ValueError(f'{what} takes 16-byte aligned rows and blocks')
    scales = (k_scale, v_scale, ks_buf, vs_buf) if int8 else ()
    if any(t.dtype != F32 for t in scales):
        raise TypeError(f'{what} takes float32 scales')
    strides += [_rows_view(t, what, 2, dev) for t in scales] \
        or [0, 0, 0, 0]
    if any(t.data_ptr() % 16 or t.stride(0) % 4 for t in scales):
        raise ValueError(f'{what} takes 16-byte aligned scales and scale '
                         f'strides')
    for t in (block_tables, seq_lens):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f'{what} takes contiguous int32 tables and '
                             f'seq_lens on {dev}')
    return _run_buffered(what, q.to(BF16).contiguous(), codes,
                         scales or (None,) * 4, block_tables, seq_lens, step,
                         strides)


def _run_buffered(what, q, codes, scales, block_tables, seq_lens, step,
                  strides):
    """Allocates the context and launches row 13 on checked inputs: codes
    (k_pool, v_pool, kbuf, vbuf), scales (k_scale, v_scale, ks_buf, vs_buf)
    or Nones, strides their leading ones in the same order."""
    B, KV, rep, Dh = q.shape
    k_pool, v_pool, kbuf, vbuf = codes
    NB, BLK, _ = k_pool.shape
    dev = q.device
    ctx = torch.empty((B, KV, rep, Dh), dtype=F32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = library('paged_attention')
    with torch.cuda.device(dev):
        rc = lib.ppq_paged_attention_buffered(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ptr(scales[0]), ptr(scales[1]), block_tables.data_ptr(),
            seq_lens.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
            ptr(scales[2]), ptr(scales[3]), ctx.data_ptr(),
            fault_word(dev).data_ptr(), int(k_pool.dtype == BF16), B, KV,
            rep, Dh, block_tables.shape[1], NB, BLK, kbuf.shape[1], step,
            strides[0], strides[1], strides[4], strides[5], strides[2],
            strides[3], strides[6], strides[7], _inv_sqrt(Dh),
            stream_of(dev))
    check(rc, what)
    LAUNCHES[what] += 1
    return ctx
