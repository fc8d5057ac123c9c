"""Paged KV cache: sequences draw fixed-size blocks from one shared pool
instead of reserving max_batch x max_seq_len up front. The single-card part
of the JAX package's `ppq_tpu/serving/paged.py`, function for function.

Layouts (the JAX package's, which its kernels and this port's read):
  kv pool (L, NB, 2, BLK, KV*Dh) int8 | bf16, K in plane 0 and V in plane 1
  of every block row; kv_scale (L, NB, 2, KV, BLK) f32 for an int8 cache.
Row 0 is the TRASH block: unallocated table entries and inactive slots
point there. The pool write (kernels/pool_write.py) writes nothing there;
the JAX package dumps those tokens into it. Nothing reads it unmasked.

The host-side BlockAllocator hands out pool rows; the card only sees
(B, MB) int32 block tables. Writes go through the pool-write kernel (row 16
of the kernel table): one launch a prefill or a burst writes every layer's
window, for a window of any length. A decode burst reads the frozen pool
through a repack of its window into the grouped paged-attention kernel's
block-major layout (row 12), as the JAX package's kernel path does; the
burst's own columns live in small buffers (bank-write kernel, row 14) and
join by an exact merge of partial softmaxes.

The allocator is a Python free list unless `native=True` or
`PPQ_TPU_NATIVE_ALLOC=1` asks for the repository's native C++ one
(`csrc/allocator.cc`, built at first use by `utils/native.py`; the Python
list where the build fails): both give the same allocation order, and on the
serving paths' calls the Python list is the faster (PERF.md §5).

On a tp or dp x tp mesh each rank's pools hold its kv heads
(`init_paged_pools` with the rank's config), and every rank keeps the same
allocator, tables and prefix cache; rows 12 and 16 run on the local heads.

On an 'sp' mesh the pools' BLOCK axis is sharded (over 'dp' and 'sp',
dp-major, on a dp x sp mesh): a rank holds global rows [offset, offset +
size) at local rows 1 .. size, and local row 0 is its own trash row, where
the other shards' blocks and the global trash row map (`BlockShard`). The
tables stay global on every rank (one allocator, the dp-grouped one on a
dp x sp mesh, `GroupedBlockAllocator`). The three pool-touching operations
localize them:
  * reads (`paged_decode_sp`): a slot's blocks on this shard, moved to the
    front of its table row in table order, with the positions they hold as
    its fill, go through the repack and row 12; the partial softmaxes merge
    exactly over the shard's groups (`pipeline._sp_merge_triple`);
  * writes (`write_kv_window_sp`): row 16 on the local pool, the other
    shards' blocks pointing at the local trash row, which it never writes;
  * the chunked prefill's prefix (`gather_prefix_sp`): each shard gathers
    its blocks, zeros elsewhere, and a sum over the groups rebuilds it.
Every rank computes every slot ('dp' replicates the compute, as on the
dense engine); a slot's blocks lie on its dp row's shards, the others
contribute empty partial softmaxes (recorded difference 57: the JAX
package masks table entries inside its XLA read and splits the batch over
dp). The JAX package's `_tp_name`, `_dp_name`
and `_block_axes` place its shard_map specs; here a rank's pools are its
slices already (`tensor_parallel.pool_shardings`).

On a 'pp' mesh (serving/pipeline.py) a rank's pools hold its stage's
layers, and the functions here run the stage's layers on microbatches
(`stages`, a `pipeline._Stages`).
"""

from __future__ import annotations

import hashlib
import math
import os
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..executor.executor import resolve_device
from ..kernels import bank_write as _bank
from ..kernels import paged_attention as _pa
from ..kernels import pool_write as _pool
from .config import LlamaConfig
from ..parallel.multihost import all_reduce
from .model import (BF16, F32, Params, _kv_quant, _pv_context, _qk_logits,
                    _run_layers, mlp, project_qkv, qmatmul, rms_norm,
                    rope_apply, rope_tables, row_rsqrt)
from .pipeline import _sp_block_offset, _sp_merge_triple

# the allocator's default block size (the JAX package's); the engine passes
# cfg.kv_block_size, and the functions read the pool's own
BLK = 128


def pool_block_size(pools: Dict) -> int:
    """Token granularity of an allocated pool (its BLK axis)."""
    return pools['kv'].shape[3]


# ---------------------------------------------------------- pool + tables --

def init_paged_pools(cfg: LlamaConfig, num_blocks: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """The shared block pools on `device` (the card unless named).
    num_blocks INCLUDES the reserved trash block 0."""
    device = resolve_device(device)
    L, KV, Dh, blk = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, \
        cfg.kv_block_size
    if cfg.kv_cache_bits == 8:
        return {
            'kv': torch.zeros((L, num_blocks, 2, blk, KV * Dh),
                              dtype=torch.int8, device=device),
            'kv_scale': torch.zeros((L, num_blocks, 2, KV, blk), dtype=F32,
                                    device=device),
        }
    return {'kv': torch.zeros((L, num_blocks, 2, blk, KV * Dh), dtype=BF16,
                              device=device)}


class BlockAllocator:
    """Host-side free list over pool rows [1, num_blocks), row 0 being the
    trash block, with a reference count per row (prefix sharing). Tracks
    each slot's logical -> physical block list.

    Two backends with the same allocation order
    (tests/test_native_allocator.py, tests/test_torch_native_io.py): this
    Python list, and the native C++ allocator (the repository's
    csrc/allocator.cc through ctypes, `native_alloc`) where `native` is True,
    or None with PPQ_TPU_NATIVE_ALLOC=1, and the toolchain builds it. The
    JAX package takes the native one by default; here the Python list is the
    default, being the faster on the serving paths' calls (a ctypes call
    costs more than the list operation it replaces; PERF.md §5). `backend`
    says which runs."""

    def __init__(self, num_blocks: int, max_batch: int,
                 max_blocks_per_seq: int, block_size: int = BLK,
                 native: Optional[bool] = None):
        self.num_blocks = num_blocks
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.block_size = block_size
        self._nlib = None
        self._handle = 0
        if native is None:
            native = os.environ.get('PPQ_TPU_NATIVE_ALLOC', '0') != '0'
        if native:
            from ..utils.native import native_alloc
            lib = native_alloc()
            if lib is not None:
                handle = lib.create(num_blocks, max_batch,
                                    max_blocks_per_seq, block_size)
                if handle:
                    self._nlib, self._handle = lib, handle
                    # slot_block_ids reads its row from here: the C source
                    # has no one-row read, only the whole table
                    self._row_buf = np.zeros((max_batch, max_blocks_per_seq),
                                             np.int32)
        if self._nlib is None:
            self.free: List[int] = list(range(num_blocks - 1, 0, -1))
            self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
            self._refs: List[int] = [0] * num_blocks

    @property
    def backend(self) -> str:
        return 'native' if self._nlib is not None else 'python'

    def __del__(self):
        if getattr(self, '_nlib', None) is not None and self._handle:
            self._nlib.destroy(self._handle)
            self._handle = 0

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f'native allocator {what} rc={rc}')

    @property
    def free_blocks(self) -> int:
        if self._nlib is not None:
            return self._nlib.free_blocks(self._handle)
        return len(self.free)

    def ensure(self, slot: int, tokens: int) -> None:
        """Grow slot's block list to cover `tokens` positions; all or
        nothing when the pool runs out."""
        need = -(-tokens // self.block_size)
        if self._nlib is not None:
            rc = self._nlib.ensure(self._handle, slot, tokens)
            if rc == -2:
                raise ValueError(f'sequence needs {need} blocks > '
                                 f'max {self.max_blocks_per_seq}')
            if rc == -1:
                raise MemoryError('KV block pool exhausted')
            self._check(rc, 'ensure')
            return
        if need > self.max_blocks_per_seq:
            raise ValueError(f'sequence needs {need} blocks > '
                             f'max {self.max_blocks_per_seq}')
        have = self.slot_blocks[slot]
        before = len(have)
        while len(have) < need:
            if not self.free:
                while len(have) > before:
                    b = have.pop()
                    self._refs[b] = 0
                    self.free.append(b)
                raise MemoryError('KV block pool exhausted')
            have.append(self.free.pop())
            self._refs[have[-1]] = 1

    def adopt(self, slot: int, blocks) -> None:
        """Attach EXISTING (live) blocks, a cached prefix, to the front of
        an EMPTY slot's list, taking one reference each."""
        if self._nlib is not None:
            self._check(self._nlib.adopt(self._handle, slot, list(blocks)),
                        'adopt')
            return
        assert not self.slot_blocks[slot], 'adopt needs an empty slot'
        for b in blocks:
            assert self._refs[b] > 0, f'adopting dead block {b}'
            self.slot_blocks[slot].append(int(b))
            self._refs[b] += 1

    def retain(self, blocks) -> None:
        """Standalone references (the prefix cache's own holds)."""
        if self._nlib is not None:
            self._check(self._nlib.retain(self._handle, list(blocks)),
                        'retain')
            return
        for b in blocks:
            assert self._refs[b] > 0
            self._refs[b] += 1

    def unref(self, blocks) -> None:
        if self._nlib is not None:
            self._check(self._nlib.unref(self._handle, list(blocks)), 'unref')
            return
        for b in reversed(list(blocks)):
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self.free.append(int(b))

    def slot_block_ids(self, slot: int) -> List[int]:
        """The slot's current block list (its table row's prefix)."""
        if self._nlib is not None:
            n = self._nlib.slot_blocks(self._handle, slot)
            if n == 0:
                return []
            self._nlib.tables(self._handle, self.max_batch,
                              self.max_blocks_per_seq, out=self._row_buf)
            return self._row_buf[slot, :n].tolist()
        return list(self.slot_blocks[slot])

    def release(self, slot: int) -> None:
        if self._nlib is not None:
            self._check(self._nlib.release(self._handle, slot), 'release')
            return
        self.unref(self.slot_blocks[slot])
        self.slot_blocks[slot] = []

    def tables(self) -> np.ndarray:
        """(B, MB) int32 tables; unallocated entries point at the trash
        block 0."""
        if self._nlib is not None:
            return self._nlib.tables(self._handle, self.max_batch,
                                     self.max_blocks_per_seq)
        t = np.zeros((self.max_batch, self.max_blocks_per_seq), np.int32)
        for s, blocks in enumerate(self.slot_blocks):
            t[s, :len(blocks)] = blocks
        return t


class GroupedBlockAllocator:
    """Block allocator partitioned into `groups` disjoint row ranges: the
    dp-sharded pool of a dp x sp mesh. Batch slots partition over the dp
    rows, and a slot's blocks must lie on its dp row's shards, so group g's
    slots draw only from global rows [g*NBg, (g+1)*NBg). Each group's local
    row 0 is reserved (group 0's is the global trash row): one
    BlockAllocator a group. tables() / slot_block_ids() speak GLOBAL row
    ids."""

    def __init__(self, num_blocks: int, max_batch: int,
                 max_blocks_per_seq: int, block_size: int = BLK,
                 groups: int = 1, native: Optional[bool] = None):
        assert num_blocks % groups == 0, (num_blocks, groups)
        assert max_batch % groups == 0, (max_batch, groups)
        self.num_blocks = num_blocks
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.block_size = block_size
        self.groups = groups
        self._nbg = num_blocks // groups
        self._bg = max_batch // groups
        self._subs = [BlockAllocator(self._nbg, self._bg, max_blocks_per_seq,
                                     block_size, native=native)
                      for _ in range(groups)]

    @property
    def backend(self) -> str:
        return self._subs[0].backend

    def _loc(self, slot: int):
        return self._subs[slot // self._bg], slot % self._bg, \
            (slot // self._bg) * self._nbg

    @property
    def free_blocks(self) -> int:
        return sum(s.free_blocks for s in self._subs)

    def ensure(self, slot: int, tokens: int) -> None:
        sub, ls, _ = self._loc(slot)
        sub.ensure(ls, tokens)

    def release(self, slot: int) -> None:
        sub, ls, _ = self._loc(slot)
        sub.release(ls)

    def slot_block_ids(self, slot: int) -> List[int]:
        sub, ls, off = self._loc(slot)
        return [b + off for b in sub.slot_block_ids(ls)]

    def adopt(self, slot: int, blocks) -> None:
        sub, ls, off = self._loc(slot)
        for b in blocks:
            if not off <= int(b) < off + self._nbg:
                raise ValueError("adopt: block outside the slot's dp group "
                                 '(prefix sharing does not cross dp rows)')
        sub.adopt(ls, [int(b) - off for b in blocks])

    def retain(self, blocks) -> None:
        for b in blocks:
            g = int(b) // self._nbg
            self._subs[g].retain([int(b) - g * self._nbg])

    def unref(self, blocks) -> None:
        for b in blocks:
            g = int(b) // self._nbg
            self._subs[g].unref([int(b) - g * self._nbg])

    def tables(self) -> np.ndarray:
        # global ids; a group's unallocated entries land on its own trash
        # row g*NBg (the global trash row 0 for group 0), never read
        return np.concatenate([sub.tables() + np.int32(g * self._nbg)
                               for g, sub in enumerate(self._subs)], axis=0)


# ------------------------------------------------------------- writes ------

def write_kv_window(pools, k_all, v_all, ks_all, vs_all, tables, write_pos,
                    active=None):
    """Write a T-token window of every layer into the pools, in place,
    through the pool-write kernel (one launch). k/v_all (L, B, T, KV, Dh);
    ks/vs_all (L, B, KV, T) f32 or None; tables (B, MB) int32; write_pos
    (B,) int32; active (B,) bool or None. The JAX package switches to an
    XLA scatter for a window longer than a block; the kernel writes any
    length, with the same values. Returns the pools."""
    _pool.pool_write_inplace(pools['kv'], pools.get('kv_scale'), k_all,
                             v_all, ks_all, vs_all, tables, write_pos, active)
    return pools


# ------------------------------------------ sp (block-axis) sharding -------

class BlockShard(NamedTuple):
    """A rank's share of a pool whose block axis is sharded: global rows
    [offset, offset + size) at local rows 1 .. size (local row 0 is the
    rank's trash row); its partial reads merge over `groups` (the 'sp'
    line, then the 'dp' line)."""
    offset: int
    size: int
    groups: tuple


def _sp_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get('sp', 1)


def _shard_block_offset(mesh, nb_local: int) -> int:
    """This shard's first global pool row (dp-major over ('dp', 'sp'))."""
    row = mesh.index('dp') * _sp_size(mesh) if mesh.shape.get('dp', 1) > 1 \
        else 0
    return row * nb_local + _sp_block_offset(mesh, nb_local)


def block_shard(pools: Dict, mesh) -> Optional[BlockShard]:
    """The BlockShard of this rank's `pools` on `mesh` (None: no 'sp'
    axis)."""
    if _sp_size(mesh) == 1:
        return None
    size = pools['kv'].shape[1] - 1
    return BlockShard(_shard_block_offset(mesh, size), size,
                      (mesh.group('sp'), mesh.group('dp')))


def _local_rows(tables: torch.Tensor, shard: BlockShard):
    """Global block ids (B, MB) -> (local rows int32, the mask of the
    entries on this shard); the others, and the global trash row, map to
    the local trash row 0."""
    t = tables.long()
    loc = t - shard.offset
    mine = (loc >= 0) & (loc < shard.size) & (t != 0)
    return torch.where(mine, loc + 1, 0).to(torch.int32), mine


def _local_window(tables: torch.Tensor, seq_lens: torch.Tensor,
                  shard: BlockShard, blk: int):
    """This shard's part of each slot's frozen window: the slot's blocks on
    the shard moved to the front of its table row (table order kept, the
    rest pointing at the trash row) and the positions below its fill that
    they hold, as its fill. The positions below a fill fill whole blocks
    but the last, so the blocks kept hold them in one run from the row's
    start: the read sees exactly the shard's keys. Returns (tables (B, MB)
    int32 local rows, fills (B,) int32)."""
    loc, mine = _local_rows(tables, shard)
    start = torch.arange(tables.shape[1], device=tables.device) * blk
    held = torch.clamp(seq_lens.long()[:, None] - start, 0, blk) * mine
    order = torch.sort((~mine).to(torch.int32), dim=1, stable=True).indices
    return (torch.gather(loc, 1, order).contiguous(),
            held.sum(1).to(torch.int32))


def paged_decode_sp(q, kv_pool, kv_scale, tables, seq_lens, layer, mesh):
    """The paged read of one layer over a block-sharded pool: the same
    (acc, m, l) triple as the read of the whole pool, up to rounding (the
    shards' partial softmaxes cover disjoint key sets). q (B, KV, rep, Dh);
    kv_pool (L, 1 + NB/shards, 2, BLK, KV*Dh), kv_scale (L, ..., 2, KV, BLK)
    or None: this rank's pools; tables (B, MB) GLOBAL block ids; layer: an
    int. The shard's blocks go through the frozen-window repack and the
    grouped kernel (row 12), then `_sp_merge_triple`."""
    pools = {'kv': kv_pool[layer:layer + 1]}
    if kv_scale is not None:
        pools['kv_scale'] = kv_scale[layer:layer + 1]
    shard = block_shard(pools, mesh)
    ltab, fills = _local_window(tables, seq_lens, shard,
                                pool_block_size(pools))
    kv_bm, sc_bm, RBLK = gather_window(pools, ltab)
    B, KV, rep, Dh = q.shape
    G = _pa.grouped_group_size(B, RBLK, KV * Dh,
                               kv_pool.element_size(), KV * rep)
    acc, m, l = _pa.paged_attention_decode_grouped(
        q, kv_bm, sc_bm, fills, layer=0, block_size=RBLK, group=G)
    return _sp_merge_triple(acc, m, l, shard.groups)


def write_kv_window_sp(pools, k_all, v_all, ks_all, vs_all, tables,
                       write_pos, active, mesh):
    """`write_kv_window` into a block-sharded pool: row 16 on the local
    pool writes the tokens whose blocks are on this shard (the others point
    at the local trash row, which it skips). Same layouts."""
    loc, _ = _local_rows(tables, block_shard(pools, mesh))
    return write_kv_window(pools, k_all, v_all, ks_all, vs_all, loc,
                           write_pos, active)


def gather_prefix_sp(kv_pool, kv_scale, tbl_p, layer, mesh):
    """Dense prefix gather from a block-sharded pool (chunked prefill): each
    shard gathers its blocks, zeros elsewhere, and a sum over the shard's
    groups rebuilds the prefix exactly (every block lies on one shard).
    Returns (kvp (B, P, 2, BLK, KV*Dh), scp (B, P, 2, KV, BLK) or None),
    what `pools['kv'][layer][tbl_p]` is on one card."""
    shard = block_shard({'kv': kv_pool}, mesh)
    loc, mine = _local_rows(tbl_p, shard)
    keep = mine[:, :, None, None, None]
    loc = loc.long()
    kvp = torch.where(keep, kv_pool[layer][loc], 0).contiguous()
    scp = None
    if kv_scale is not None:
        scp = torch.where(keep, kv_scale[layer][loc], 0.0).contiguous()
    for group in shard.groups:
        all_reduce(kvp, group)
        if scp is not None:
            all_reduce(scp, group)
    return kvp, scp


# ------------------------------------------------------------- prefill -----

def _window_context(q, k_q, v_q, k_s, v_s, causal, Dh):
    """Attention of the window's queries over its own quantized K/V (the
    cache read's numerics): q (B, T, H, Dh); k_q, v_q (B, T, KV, Dh); k_s,
    v_s (B, T, KV) or None -> (B, T, KV, rep, Dh) f32."""
    B, T, KV = k_q.shape[:3]
    q_g = q.reshape(B, T, KV, -1, Dh)
    s = _qk_logits(q_g, k_q)                                 # (B,KV,rep,T,T)
    if k_s is not None:
        s = s * k_s.transpose(1, 2)[:, :, None, None, :]
    s = torch.where(causal, s / math.sqrt(Dh), -1e30)
    p = torch.softmax(s, dim=-1)
    if v_s is not None:
        p = p * v_s.transpose(1, 2)[:, :, None, None, :]
    return _pv_context(p, v_q)


def _quantized_kv(k, v, int8_cache, dtype):
    if int8_cache:
        k_q, k_s = _kv_quant(k)
        v_q, v_s = _kv_quant(v)
        return k_q, v_q, k_s, v_s
    return k.to(dtype), v.to(dtype), None, None


def _pool_writer(pools, sp_mesh):
    """write_kv_window, or write_kv_window_sp on a block-sharded pool."""
    if sp_mesh is None or _sp_size(sp_mesh) == 1:
        return write_kv_window
    return lambda *a: write_kv_window_sp(*a, mesh=sp_mesh)


def _window_buffers(L, B, T, KV, Dh, dtype, int8_cache, dev):
    """Every layer's quantized K/V of a window, filled microbatch by
    microbatch: codes (L, B, T, KV, Dh) and scales (L, B, T, KV) or
    None."""
    codes = [torch.empty((L, B, T, KV, Dh), dtype=dtype, device=dev)
             for _ in range(2)]
    scales = [torch.empty((L, B, T, KV), dtype=F32, device=dev)
              if int8_cache else None for _ in range(2)]
    return codes, scales


def prefill_paged(params: Params, pools: Dict, tokens, lengths, tables,
                  active, cfg: LlamaConfig, sp_mesh=None,
                  stages=None) -> Tuple[torch.Tensor, Dict]:
    """Batched masked prefill into the paged pools. Prompts start at
    position 0, so attention is causal within the (B, T) window itself: the
    pool is written (one pool-write launch for all layers), never read.
    Returns (logits (B, T, vocab) f32, the pools, updated in place).

    sp_mesh: the mesh of a block-sharded pool (the write localizes its
    rows, `write_kv_window_sp`). stages: a `pipeline._Stages`: the layers
    and pools are this rank's stage's, run on its microbatches."""
    B, T = tokens.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    int8_cache = cfg.kv_cache_bits == 8
    kern = bool(cfg.use_kernel_matmul)
    a8 = cfg.act_bits == 8
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None] \
        .expand(B, T)
    x = params['embed'][tokens.long()]
    causal = (torch.arange(T, device=dev)[None, :]
              <= torch.arange(T, device=dev)[:, None])       # (T, T)
    r_cos, r_sin = rope_tables(positions, cfg.rope_theta, Dh)
    layers = params['layers']
    (k_all, v_all), (ks_all, vs_all) = _window_buffers(
        len(layers), B, T, KV, Dh, pools['kv'].dtype, int8_cache, dev)

    def body(x, part, rows):
        n = x.shape[0]
        for li, layer in enumerate(layers):
            h = rms_norm(x, layer['attn_norm'], cfg.rms_eps)
            q, k, v = project_qkv(h, layer, cfg, kern)
            q = rope_apply(q, r_cos[rows], r_sin[rows])
            k = rope_apply(k, r_cos[rows], r_sin[rows])
            k_q, v_q, k_s, v_s = _quantized_kv(k, v, int8_cache,
                                               pools['kv'].dtype)
            k_all[li, rows] = k_q
            v_all[li, rows] = v_q
            if int8_cache:
                ks_all[li, rows] = k_s
                vs_all[li, rows] = v_s
            ctx = _window_context(q, k_q, v_q, k_s, v_s, causal, Dh)
            ctx = ctx.reshape(n, T, H * Dh).to(x.dtype)
            x = x + qmatmul(ctx, layer['wo'], kernel=kern, a8=a8)
            h = rms_norm(x, layer['mlp_norm'], cfg.rms_eps)
            x = x + mlp(h, layer, cfg)
        return x
    x = _run_layers(x, body, stages)
    _pool_writer(pools, sp_mesh)(
        pools, k_all, v_all,
        ks_all.transpose(2, 3) if int8_cache else None,
        vs_all.transpose(2, 3) if int8_cache else None,
        tables, torch.zeros((B,), dtype=torch.int32, device=dev), active)
    x = rms_norm(x, params['final_norm'], cfg.rms_eps)
    logits = qmatmul(x, params['lm_head'], kernel=kern, a8=a8)
    # lm_head may be padded for the kernel's tiling (fuse_decode_params)
    return logits[..., :cfg.vocab_size].to(F32), pools


def prefill_chunk_paged(params: Params, pools: Dict, tokens, write_pos,
                        tables, active, prefix_blocks: int,
                        cfg: LlamaConfig, sp_mesh=None,
                        stages=None) -> Tuple[torch.Tensor, Dict]:
    """Continuation prefill into the paged pools: write `chunk` tokens at
    per-slot offsets write_pos, attending over the blocks already written
    (gathered densely through the block tables) plus the causal window
    itself. prefix_blocks bounds the gathered prefix (the engine passes a
    power of two covering max(write_pos) / BLK).

    tokens: (B, chunk); write_pos: (B,) int32; active: (B,) bool.
    sp_mesh, stages: as `prefill_paged` (the prefix of a block-sharded pool
    is rebuilt by `gather_prefix_sp`).
    Returns (logits (B, chunk, vocab) f32, the pools, updated in place)."""
    B, T = tokens.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    int8_cache = cfg.kv_cache_bits == 8
    kern = bool(cfg.use_kernel_matmul)
    a8 = cfg.act_bits == 8
    dev = tokens.device
    Sp = prefix_blocks * pool_block_size(pools)
    root_dh = math.sqrt(Dh)
    sharded = sp_mesh is not None and _sp_size(sp_mesh) > 1
    positions = write_pos.to(torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32, device=dev)[None]
    x = params['embed'][tokens.long()]
    causal = (torch.arange(T, device=dev)[None, :]
              <= torch.arange(T, device=dev)[:, None])       # (T, T)
    # every chunk query sees exactly the prefix [0, write_pos): the chunk's
    # own tokens are not in the pool yet and join through the causal term
    pfx_mask = torch.arange(Sp, device=dev)[None, None, None, None, :] \
        < write_pos.long()[:, None, None, None, None]        # (B,1,1,1,Sp)
    tbl_p = tables[:, :prefix_blocks].long()                 # (B, P)
    r_cos, r_sin = rope_tables(positions, cfg.rope_theta, Dh)
    layers = params['layers']
    (k_all, v_all), (ks_all, vs_all) = _window_buffers(
        len(layers), B, T, KV, Dh, pools['kv'].dtype, int8_cache, dev)

    def body(x, part, rows):
        n = x.shape[0]
        for li, layer in enumerate(layers):
            h = rms_norm(x, layer['attn_norm'], cfg.rms_eps)
            q, k, v = project_qkv(h, layer, cfg, kern)
            q = rope_apply(q, r_cos[rows], r_sin[rows])
            k = rope_apply(k, r_cos[rows], r_sin[rows])
            k_q, v_q, k_s, v_s = _quantized_kv(k, v, int8_cache,
                                               pools['kv'].dtype)
            k_all[li, rows] = k_q
            v_all[li, rows] = v_q
            if int8_cache:
                ks_all[li, rows] = k_s
                vs_all[li, rows] = v_s
            # the written prefix, gathered before this chunk's write (all
            # writes wait for the end)
            if sharded:
                kvp, scp = gather_prefix_sp(pools['kv'], pools.get('kv_scale'),
                                            tbl_p[rows], li, sp_mesh)
            else:
                kvp = pools['kv'][li][tbl_p[rows]]    # (n, P, 2, BLK, KVDh)
                scp = pools['kv_scale'][li][tbl_p[rows]] if int8_cache \
                    else None                         # (n, P, 2, KV, BLK)
            kp = kvp[:, :, 0].reshape(n, Sp, KV, Dh)
            vp = kvp[:, :, 1].reshape(n, Sp, KV, Dh)
            q_g = q.reshape(n, T, KV, rep, Dh)
            lp = _qk_logits(q_g, kp)                  # (n,KV,rep,T,Sp)
            if int8_cache:
                kps = scp[:, :, 0].transpose(1, 2).reshape(n, KV, Sp)
                vps = scp[:, :, 1].transpose(1, 2).reshape(n, KV, Sp)
                lp = lp * kps[:, :, None, None, :]
            lp = torch.where(pfx_mask[rows], lp / root_dh, -1e30)
            lc = _qk_logits(q_g, k_q)                 # (n,KV,rep,T,T)
            if int8_cache:
                lc = lc * k_s.transpose(1, 2)[:, :, None, None, :]
            lc = torch.where(causal, lc / root_dh, -1e30)
            probs = torch.softmax(torch.cat([lp, lc], dim=-1), dim=-1)
            pp, pc = probs[..., :Sp], probs[..., Sp:]
            if int8_cache:
                pp = pp * vps[:, :, None, None, :]
                pc = pc * v_s.transpose(1, 2)[:, :, None, None, :]
            ctx = _pv_context(pp, vp) + _pv_context(pc, v_q)
            ctx = ctx.reshape(n, T, H * Dh).to(x.dtype)
            x = x + qmatmul(ctx, layer['wo'], kernel=kern, a8=a8)
            h = rms_norm(x, layer['mlp_norm'], cfg.rms_eps)
            x = x + mlp(h, layer, cfg)
        return x
    x = _run_layers(x, body, stages)
    _pool_writer(pools, sp_mesh)(
        pools, k_all, v_all,
        ks_all.transpose(2, 3) if int8_cache else None,
        vs_all.transpose(2, 3) if int8_cache else None,
        tables, write_pos.to(torch.int32), active)
    x = rms_norm(x, params['final_norm'], cfg.rms_eps)
    logits = qmatmul(x, params['lm_head'], kernel=kern, a8=a8)
    return logits[..., :cfg.vocab_size].to(F32), pools


# ------------------------------------------------------------- decode ------

def gather_window(pools: Dict, tables: torch.Tensor,
                  read_limit: Optional[int] = None):
    """Repack the frozen window [0, read_limit) of every slot, in table
    order, into the grouped kernel's block-major layout: kv_bm
    (L, NBr*B, 2, RBLK, KV*Dh), row j*B + b holding slot b's read-block j;
    sc_bm (L, NBr*B, 2, KV, max(RBLK, 128)) (zero-padded columns) or None.
    RBLK and NBr are the JAX package's. One indexed copy of the codes (and
    one of the scales) into storage allocated once; the JAX package gathers
    and then transposes, two copies. Returns (kv_bm, sc_bm, RBLK)."""
    kv = pools['kv']
    L, NB, _, blk, KVDh = kv.shape
    B, MB = tables.shape
    dev = kv.device
    rl = min(read_limit or MB * blk, MB * blk)
    RBLK = rl if rl <= 64 else max(32, min(512, rl // 2))
    NBr = rl // RBLK
    pos = torch.arange(NBr * RBLK, device=dev)
    rows = tables.long()[:, pos // blk].reshape(B, NBr, 1, RBLK) \
        .transpose(0, 1)                                     # (NBr,B,1,RBLK)
    off = (pos % blk).reshape(NBr, 1, 1, RBLK)
    plane = torch.arange(2, device=dev).reshape(1, 1, 2, 1)
    # (NBr, B, 2, RBLK) rows of the pool viewed as (L, NB*2*BLK, KVDh)
    index = ((rows * 2 + plane) * blk + off).reshape(-1)
    kv_bm = torch.empty((L, NBr * B, 2, RBLK, KVDh), dtype=kv.dtype,
                        device=dev)
    # move whole rows as 8-byte words where the row divides
    word = torch.int64 if KVDh * kv.element_size() % 8 == 0 else kv.dtype
    torch.index_select(kv.view(L, NB * 2 * blk, KVDh).view(word), 1, index,
                       out=kv_bm.view(L, -1, KVDh).view(word))
    sc_bm = None
    if 'kv_scale' in pools:
        sc = pools['kv_scale']
        KV = sc.shape[3]
        heads = torch.arange(KV, device=dev).reshape(1, 1, 1, KV, 1)
        sindex = (((rows * 2 + plane)[:, :, :, None] * KV + heads) * blk
                  + off[:, :, :, None]).reshape(-1)
        scp = max(RBLK, 128)
        gathered = sc.view(L, -1).index_select(1, sindex) \
            .view(L, NBr * B, 2, KV, RBLK)
        if scp == RBLK:
            sc_bm = gathered
        else:
            sc_bm = torch.zeros((L, NBr * B, 2, KV, scp), dtype=F32,
                                device=dev)
            sc_bm[..., :RBLK] = gathered
    return kv_bm, sc_bm, RBLK


def burst_forward_paged(params: Params, pools: Dict, tokens: torch.Tensor,
                        seq_lens: torch.Tensor, tables: torch.Tensor,
                        n_steps: int, cfg: LlamaConfig, select_fn,
                        chunk: Optional[int] = None,
                        read_limit: Optional[int] = None, observe=None,
                        sp_mesh=None, stages=None):
    """n decode steps over the paged pools, the pool frozen during the
    burst: in-burst K/V live in small (L, B, n, KV, Dh) buffers, banked one
    column a step (one bank-write launch over all layers), and the pool is
    written ONCE at the burst's end (one pool-write launch).

    The frozen window [0, read_limit) is repacked once a burst into the
    grouped kernel's block-major layout (`gather_window`), and every step
    and layer reads it through the grouped paged-attention kernel (row 12)
    as a partial softmax. The burst's earlier columns (the buffer part) and
    the step's own K/V (the self part: p = 1, l = 1) are two more partial
    softmaxes, and `merge_attention` joins the three exactly: the JAX
    package's kernel path, operation for operation.

    chunk: the burst's columns are read in chunks of that many, finished
    chunks unmasked and the current one masked (the JAX package's chunked
    scan carry; here the chunks are views of one buffer).

    sp_mesh: the mesh of a block-sharded pool: the repack takes this
    shard's blocks of each slot (`_local_window`), the frozen part merges
    over the shard's groups before the other two, and the write localizes
    its rows. stages: a `pipeline._Stages`: the layers and pools are this
    rank's stage's, each microbatch repacked on its own.

    observe: optional callable(dict) called after each layer's attention
    with that step's inputs and its context (`layer`, `step`, `q`
    (B, KV, rep, Dh), `ctx` (B, KV, rep, Dh) f32, the layer's buffers
    `kbuf`, `vbuf` (B, n, KV, Dh), `ksb`, `vsb` (B, KV, n) holding columns
    below `step`, the step's own `k`, `v` (B, KV, Dh) and `ks`, `vs`
    (B, KV) or None, `seq_lens`, `tables`); it must not change them. On a
    pipeline the same, of a microbatch's rows.

    tokens: (B,) current token per slot; seq_lens: (B,) int32 fills;
    tables: (B, MB) int32; select_fn(logits (B, vocab) f32, step index) ->
    (B,) next tokens. Returns (toks (n, B) int32, the pools, updated in
    place)."""
    layers = params['layers']
    L = len(layers)
    B = tokens.shape[0]
    n = int(n_steps)
    KV, Dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    rep = H // KV
    int8_cache = cfg.kv_cache_bits == 8
    kern = bool(cfg.use_kernel_matmul)
    a8 = cfg.act_bits == 8
    folded = bool(cfg.norm_folded)
    dev = tokens.device
    seq_lens = seq_lens.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    root_dh = math.sqrt(Dh)
    buf_dtype = pools['kv'].dtype
    shard = None if sp_mesh is None else block_shard(pools, sp_mesh)
    if chunk is not None:
        CH = chunk if (n > chunk and n % chunk == 0) else n
    else:
        CH = n
    bank_kernel = _bank.supports_bank((L * B, CH, KV, Dh))
    kbuf = torch.zeros((L, B, n, KV, Dh), dtype=buf_dtype, device=dev)
    vbuf = torch.zeros((L, B, n, KV, Dh), dtype=buf_dtype, device=dev)
    # buffer scales TRANSPOSED (L, B, KV, n), the pool write's layout
    ksb = torch.zeros((L, B, KV, n), dtype=F32, device=dev)
    vsb = torch.zeros((L, B, KV, n), dtype=F32, device=dev)
    buf_ids = torch.arange(CH, device=dev)[None, None, None, :]
    columns = torch.arange(CH, dtype=torch.int32, device=dev)
    # the frozen window of each microbatch (one on one card), repacked once
    M = 1 if stages is None else stages.microbatches
    windows = []
    for part in range(M):
        rows = slice(part * B // M, (part + 1) * B // M)
        tbl, fills = tables[rows], seq_lens[rows]
        if shard is not None:
            tbl, fills = _local_window(tbl, fills, shard,
                                       pool_block_size(pools))
        kv_bm, sc_bm, RBLK = gather_window(pools, tbl, read_limit)
        G = _pa.grouped_group_size(B // M, RBLK, KV * Dh,
                                   1 if int8_cache else 2, H)
        windows.append((kv_bm, sc_bm, RBLK, G, fills))

    def buf_logits(q_g, buf, scales, lim):
        """q against (b, CH, KV, Dh) codes -> (b, KV, rep, CH); lim:
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
            bank = _bank.Bank([kbuf[li][:, span] for li in range(L)]
                              + [vbuf[li][:, span] for li in range(L)])
        x = params['embed'][cur_tok.long()][:, None, :]      # (B,1,D)
        r_cos, r_sin = rope_tables((seq_lens + i)[:, None], cfg.rope_theta,
                                   Dh)
        # this step's codes and scales of every layer, a part a microbatch
        k_new, v_new, ks_new, vs_new = ([[] for _ in range(L)]
                                        for _ in range(4))

        def body(x, part, rows):
            kv_bm, sc_bm, RBLK, G, fills = windows[part]
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
                k_q, v_q, k_s, v_s = _quantized_kv(k, v, int8_cache,
                                                   buf_dtype)
                k_new[li].append(k_q.contiguous())
                v_new[li].append(v_q.contiguous())
                if int8_cache:
                    ks_new[li].append(k_s[:, 0])
                    vs_new[li].append(v_s[:, 0])
                q_g = q.reshape(b, 1, KV, rep, Dh)
                # the frozen part: the grouped kernel over the repacked
                # window (on a sharded pool this shard's part, merged)
                acc_f, m_f, l_f = _pa.paged_attention_decode_grouped(
                    q_g[:, 0], kv_bm, sc_bm, fills, layer=li,
                    block_size=RBLK, group=G)
                if shard is not None:
                    acc_f, m_f, l_f = _sp_merge_triple(acc_f, m_f, l_f,
                                                       shard.groups)
                # the buffer part: finished chunks + the current chunk's
                # written columns (the step's own column joins as the self
                # part)
                kb, vb = kbuf[li][rows], vbuf[li][rows]
                ksl, vsl = ksb[li][rows], vsb[li][rows]
                lb_parts, v_chunks, vs_chunks = [], [], []
                for f0 in range(0, c0 + CH, CH):
                    cols = slice(f0, f0 + CH)
                    lb_parts.append(buf_logits(q_g, kb[:, cols],
                                               ksl[:, :, cols],
                                               ic if f0 == c0 else None))
                    v_chunks.append(vb[:, cols])
                    vs_chunks.append(vsl[:, :, cols])
                lb = torch.cat(lb_parts, dim=-1) if len(lb_parts) > 1 \
                    else lb_parts[0]
                m_b = lb.amax(-1)                            # (b,KV,rep)
                p_b = torch.exp(lb - m_b[..., None])
                l_b = p_b.sum(-1)
                acc_b = None
                for ci, (vc, vs) in enumerate(zip(v_chunks, vs_chunks)):
                    p = p_b[..., ci * CH:(ci + 1) * CH]
                    if int8_cache:
                        p = p * vs[:, :, None, :]
                    t = _pv_context(p[:, :, :, None, :], vc)[:, 0]
                    acc_b = t if acc_b is None else acc_b + t
                # the self part: this step's own quantized K/V column
                m_s = torch.einsum('bkrd,bkd->bkr',
                                   q_g[:, 0].to(BF16).to(F32),
                                   k_q[:, 0].to(BF16).to(F32))
                if int8_cache:
                    m_s = m_s * k_s[:, 0][:, :, None]
                m_s = m_s / root_dh
                acc_s = v_q[:, 0].to(F32)[:, :, None, :].expand(b, KV, rep,
                                                                Dh)
                if int8_cache:
                    acc_s = acc_s * v_s[:, 0][:, :, None, None]
                ctx = _pa.merge_attention([(acc_f, m_f, l_f),
                                           (acc_b, m_b, l_b),
                                           (acc_s, m_s, torch.ones_like(m_s))])
                if observe is not None:
                    observe(dict(
                        layer=li, step=i, q=q_g[:, 0], ctx=ctx, kbuf=kb,
                        vbuf=vb, ksb=ksl, vsb=vsl, k=k_q[:, 0], v=v_q[:, 0],
                        ks=None if k_s is None else k_s[:, 0],
                        vs=None if v_s is None else v_s[:, 0],
                        seq_lens=seq_lens[rows], tables=tables[rows]))
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
        k_new, v_new, ks_new, vs_new = (
            [torch.cat(p) if len(p) > 1 else p[0] for p in parts]
            for parts in (k_new, v_new, ks_new, vs_new))
        # this step's column of every layer lands at column i: codes through
        # one bank-write launch where the head dim takes it, scales as one
        # indexed write per kind
        if bank_kernel:
            _bank.bank_write_inplace(bank, k_new + v_new, columns[ic:ic + 1])
        else:
            kbuf[:, :, i] = torch.stack(k_new)[:, :, 0]
            vbuf[:, :, i] = torch.stack(v_new)[:, :, 0]
        if int8_cache:
            ksb[:, :, :, i] = torch.stack(ks_new)
            vsb[:, :, :, i] = torch.stack(vs_new)
        if folded:
            logits = qmatmul(x, params['lm_head'], kernel=kern, a8=a8,
                             row_scale=row_rsqrt(x, cfg.rms_eps)).to(F32)
        else:
            x = rms_norm(x, params['final_norm'], cfg.rms_eps)
            logits = qmatmul(x, params['lm_head'], kernel=kern, a8=a8).to(F32)
        cur_tok = select_fn(logits[:, 0, :cfg.vocab_size], i).to(torch.int32)
        toks.append(cur_tok)

    # ONE pool write for the whole burst: K/V land at seq_lens .. + n - 1
    _pool_writer(pools, sp_mesh)(
        pools, kbuf, vbuf, ksb if int8_cache else None,
        vsb if int8_cache else None, tables, seq_lens, None)
    return torch.stack(toks), pools


# ------------------------------------------------------ prefix caching -----

class PrefixCache:
    """Automatic prefix caching over the shared block pool: FULL prompt
    blocks are indexed by a digest of their token prefix, and a later
    request with the same prefix ADOPTS the cached blocks instead of
    recomputing their K/V, so its admit only prefills the tail. A block's
    K/V depend only on the token ids at its absolute positions (rope is
    absolute), so identical prefixes give identical blocks.

    Entries hold their own pool reference (BlockAllocator.retain), so a
    cached block outlives its request; eviction is LRU over chain links.
    Keys are sha1 digests of the full token prefix."""

    def __init__(self, alloc: BlockAllocator, block_size: int,
                 max_blocks: int):
        self.alloc = alloc
        self.blk = int(block_size)
        self.max = int(max_blocks)
        self.index: Dict[bytes, int] = {}
        self._lru: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _digest(prompt, n_tokens: int) -> bytes:
        arr = np.asarray(prompt[:n_tokens], np.int64)
        return hashlib.sha1(arr.tobytes()).digest()

    def match(self, prompt, slot: int = 0) -> List[int]:
        """Longest cached block chain covering full blocks of prompt[:-1]
        (at least one tail token always stays, so that the admit produces
        the next token's logits)."""
        usable = (len(prompt) - 1) // self.blk
        blocks: List[int] = []
        for i in range(usable):
            k = self._digest(prompt, (i + 1) * self.blk)
            b = self.index.get(k)
            if b is None:
                break
            blocks.append(b)
            self._lru.move_to_end(k)
        if blocks:
            self.hits += 1
        else:
            self.misses += 1
        return blocks

    def insert(self, prompt, slot_blocks: List[int], slot: int = 0) -> None:
        """Register a freshly prefilled slot's FULL blocks."""
        full = len(prompt) // self.blk
        for i in range(min(full, len(slot_blocks))):
            k = self._digest(prompt, (i + 1) * self.blk)
            if k in self.index:
                continue
            while len(self.index) >= self.max and self._lru:
                old_k, old_b = self._lru.popitem(last=False)
                del self.index[old_k]
                self.alloc.unref([old_b])
            if len(self.index) >= self.max:
                break
            b = int(slot_blocks[i])
            self.alloc.retain([b])
            self.index[k] = b
            self._lru[k] = b

    def clear(self) -> None:
        for b in self.index.values():
            self.alloc.unref([b])
        self.index.clear()
        self._lru.clear()


class GroupedPrefixCache:
    """Prefix cache over a dp-grouped pool (GroupedBlockAllocator): one
    index a dp group. A cached chain lies on ONE dp row's shards, so only
    slots of that row adopt it; the same prompt on another row prefills its
    own copy and caches it there (capacity splits evenly over the
    groups)."""

    def __init__(self, alloc: GroupedBlockAllocator, block_size: int,
                 max_blocks: int):
        self.groups = alloc.groups
        self._bg = alloc.max_batch // alloc.groups
        self._sub = [PrefixCache(alloc, block_size,
                                 max(1, max_blocks // alloc.groups))
                     for _ in range(alloc.groups)]

    def _of(self, slot: int) -> PrefixCache:
        return self._sub[slot // self._bg]

    def match(self, prompt, slot: int = 0) -> List[int]:
        return self._of(slot).match(prompt)

    def insert(self, prompt, slot_blocks: List[int], slot: int = 0) -> None:
        self._of(slot).insert(prompt, slot_blocks)

    def clear(self) -> None:
        for c in self._sub:
            c.clear()

    @property
    def hits(self) -> int:
        return sum(c.hits for c in self._sub)

    @property
    def misses(self) -> int:
        return sum(c.misses for c in self._sub)
