"""In-place write of a T-token window into the paged KV cache's block pool:
the CUDA kernel's wrapper and its plain version.

Counterpart of ppq_tpu/kernels/pool_write.py `pool_write` (`_make_writer`)
as `ppq_tpu/serving/paged.py` `write_kv_window` calls it. The kernel is
`pool_write_kernel` in `ppq_tpu_torch/csrc/kv_write.cu`; its source says
what bounds it on the card and why it writes rows where the TPU kernel
rewrote whole blocks.

    for every layer l, slot b, token t < T, at position q = write_pos[b] + t
    and pool row r = tables[b, q // BLK]:
        kv_pool[l, r, 0, q % BLK] = k[l, b, t];  kv_pool[l, r, 1, ...] = v[...]
        sc_pool[l, r, 0, :, q % BLK] = ks[l, b, :, t];  (and vs into plane 1)

The pools are (L, NB, 2, BLK, KV*Dh) int8 or bf16 and (L, NB, 2, KV, BLK)
f32 (or None for a bf16 cache); k, v are (L, B, T, KV, Dh), ks, vs
(L, B, KV, T), any strides (the burst's buffers keep that layout, a prefill
hands a transposed view). A window may be of any length and may cross any
number of blocks. Nothing is written to row 0, the trash row that inactive
slots and unallocated table entries point at, nor for a slot whose `active`
entry is False: the JAX package writes those tokens into row 0, where they
are never read. A position outside the table or a table row outside the
pool is skipped; on the card it also sets a bit of the device's fault word
(`loader.read_faults`). The JAX package's Pallas writer clamps a window
that crosses the table's last column into the start of that column's block
(ROADMAP queue 3 item 17); its scatter drops such tokens, as here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .loader import LAUNCHES, check, fault_word, library, stream_of


def _window_rows(tables, write_pos, active, T, NB, BLK):
    """(B, T) pool rows and offsets of the window, and the (B, T) mask of the
    tokens that are written."""
    pos = write_pos.to(torch.int64)[:, None] + torch.arange(
        T, device=write_pos.device)
    MB = tables.shape[1]
    inside = (pos >= 0) & (pos < MB * BLK)
    rows = torch.gather(tables.to(torch.int64), 1,
                        torch.clamp(pos // BLK, 0, MB - 1))
    ok = inside & (rows > 0) & (rows < NB)
    if active is not None:
        ok = ok & active.to(torch.bool)[:, None]
    return rows, pos % BLK, ok


def pool_write_plain(kv_pool: torch.Tensor, sc_pool: Optional[torch.Tensor],
                     k: torch.Tensor, v: torch.Tensor,
                     ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                     tables: torch.Tensor, write_pos: torch.Tensor,
                     active: Optional[torch.Tensor] = None):
    """Indexed in-place assignment, on any device (a host read of the mask).
    Returns the pools."""
    L, NB, _, BLK, KVDh = kv_pool.shape
    B, T = k.shape[1], k.shape[2]
    rows, offs, ok = _window_rows(tables, write_pos, active, T, NB, BLK)
    slot, tok = ok.nonzero(as_tuple=True)
    r, o = rows[slot, tok], offs[slot, tok]
    for plane, new in ((0, k), (1, v)):
        kv_pool[:, :, plane][:, r, o] = \
            new.reshape(L, B, T, KVDh)[:, slot, tok].to(kv_pool.dtype)
    if sc_pool is not None:
        for plane, new in ((0, ks), (1, vs)):
            # (L, B, KV, T) -> (L, B, T, KV): the pool's (L, NB, BLK, KV) view
            sc_pool[:, :, plane].transpose(-1, -2)[:, r, o] = \
                new.transpose(-1, -2)[:, slot, tok]
    return kv_pool, sc_pool


def pool_write_inplace(kv_pool: torch.Tensor, sc_pool: Optional[torch.Tensor],
               k: torch.Tensor, v: torch.Tensor, ks: Optional[torch.Tensor],
               vs: Optional[torch.Tensor], tables: torch.Tensor,
               write_pos: torch.Tensor, active: Optional[torch.Tensor] = None):
    """Write the window into the pools, in place, all layers and both planes
    in one launch. CPU tensors take the plain version; CUDA tensors the
    kernel, or a ValueError for what it does not take. Returns the pools."""
    L, NB, two, BLK, KVDh = kv_pool.shape
    if two != 2 or k.shape[:2] != (L, tables.shape[0]) \
            or k.shape != v.shape or k[0, 0, 0].numel() != KVDh:
        raise ValueError(f'pool_write: pool {tuple(kv_pool.shape)}, window '
                         f'{tuple(k.shape)}, tables {tuple(tables.shape)}')
    B, T = k.shape[1], k.shape[2]
    if (sc_pool is None) != (ks is None) or (ks is None) != (vs is None):
        raise ValueError('pool_write takes scales for an int8 pool only')
    if sc_pool is not None:
        KV = sc_pool.shape[3]
        if sc_pool.shape != (L, NB, 2, KV, BLK) or ks.shape != (L, B, KV, T) \
                or vs.shape != ks.shape:
            raise ValueError(f'pool_write: scale pool {tuple(sc_pool.shape)}, '
                             f'window scales {tuple(ks.shape)}')
    if kv_pool.device.type == 'cpu':
        return pool_write_plain(kv_pool, sc_pool, k, v, ks, vs, tables,
                                write_pos, active)
    if kv_pool.device.type != 'cuda':
        raise ValueError(f'pool_write runs on cpu or cuda, not {kv_pool.device}')
    dev = kv_pool.device
    row_bytes = KVDh * kv_pool.element_size()
    for t in (kv_pool, k, v):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('pool_write takes contiguous, 16-byte aligned '
                             'codes on one device')
    if k.dtype != kv_pool.dtype or v.dtype != kv_pool.dtype:
        raise TypeError(f'pool_write: {k.dtype} codes into a {kv_pool.dtype} '
                        f'pool')
    if row_bytes % 16:
        raise ValueError(f'pool_write moves 16-byte vectors: a row of '
                         f'{row_bytes} bytes does not divide')
    if tables.dtype != torch.int32 or write_pos.dtype != torch.int32 \
            or write_pos.shape != (B,) or tables.device != dev \
            or write_pos.device != dev or not tables.is_contiguous() \
            or not write_pos.is_contiguous():
        raise ValueError(f'pool_write takes contiguous int32 tables (B, MB) '
                         f'and write_pos ({B},) on {dev}')
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (B,) or active.device != dev
                               or not active.is_contiguous()):
        raise ValueError(f'pool_write takes active as bool ({B},) on {dev}')
    strides = (0, 0, 0, 0)
    KV = 0
    if sc_pool is not None:
        KV = sc_pool.shape[3]
        if sc_pool.dtype != torch.float32 or ks.dtype != torch.float32 \
                or vs.dtype != torch.float32 or not sc_pool.is_contiguous() \
                or any(a != b and n > 1 for a, b, n in
                       zip(ks.stride(), vs.stride(), ks.shape)) \
                or any(t.device != dev for t in (sc_pool, ks, vs)):
            raise ValueError('pool_write takes a contiguous float32 scale '
                             'pool and float32 window scales of one layout')
        strides = ks.stride()
    lib = library('kv_write')
    with torch.cuda.device(dev):
        rc = lib.ppq_pool_write(
            kv_pool.data_ptr(),
            None if sc_pool is None else sc_pool.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(),
            tables.data_ptr(), write_pos.data_ptr(),
            None if active is None else active.data_ptr(),
            fault_word(dev).data_ptr(), L, B, T, NB, tables.shape[1], BLK,
            row_bytes, KV, *strides, stream_of(dev))
    check(rc, 'pool_write')
    LAUNCHES['pool_write'] += 1
    return kv_pool, sc_pool
