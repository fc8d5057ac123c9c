"""Pipeline parallelism: the GPipe staged forward over a mesh axis, and the
cache-ful serving forwards staged over it.

Counterpart of `ppq_tpu/serving/pipeline.py`. The layers partition into
stages over the 'pp' axis, each rank holding its stage's layers (and, in
the serving forwards, those layers' cache slabs or pool rows). Microbatches
stream through the stages (`_Stages`): at tick t stage s runs microbatch
t - s (M + S - 1 ticks in all, bubbles at fill and drain) and sends its
output to stage s + 1; the last stage's outputs are broadcast to every rank
of the axis. A stage computes only on its busy ticks (the JAX package runs
every stage every tick on zeros). The chain never closes into a ring, so
blocking point-to-point calls cannot deadlock.

Embedding, final norm and lm_head are replicated: every rank of the axis
computes the same logits from the broadcast activations and takes the same
tokens.

  * `forward_staged`: the dense prefill and single step of a 'pp' engine;
  * `burst_forward_staged`: a dense decode burst with each stage's slabs
    frozen: the one-card burst's in-burst buffers, bank write (row 14 of
    the kernel table) each step and window write (row 15) at its end, on
    the stage's layers;
  * `prefill_staged_paged`, `burst_forward_staged_paged`,
    `prefill_chunk_staged_paged`: the paged engine's prefill, burst and
    chunked prefill on the stage's layers of the pool. The reads run the
    grouped paged-attention kernel (row 12) and the writes the pool-write
    kernel (row 16) on the stage's pools, where the JAX package runs its
    XLA gather and scatter (recorded difference 55).

On a pp x sp mesh the pools also shard their block axis over 'sp': each
stage's reads localize its block rows, as the flat sp paths do
(serving/paged.py), and its partial softmaxes merge over 'sp'
(`_sp_merge_triple`, the one merge every sp read shares).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..parallel.multihost import all_reduce, broadcast, recv, send


def stack_layer_params(layers) -> Dict:
    """[{leaf: tensor}] a layer -> {leaf: (L, ...) stacked}. All layers
    share a structure (true for the dense decoder); a leaf that is not a
    tensor must be equal across layers and is kept as it is."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layer_params([l[k] for l in layers]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(list(layers))
    if any(l != first for l in layers):
        raise ValueError('layers differ in a non-tensor leaf')
    return first


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i] if isinstance(stacked, torch.Tensor) else stacked


def _stage_slice(stacked, lo: int, hi: int):
    if isinstance(stacked, dict):
        return {k: _stage_slice(v, lo, hi) for k, v in stacked.items()}
    return stacked[lo:hi] if isinstance(stacked, torch.Tensor) else stacked


def _n_layers(stacked) -> int:
    if isinstance(stacked, dict):
        for v in stacked.values():
            n = _n_layers(v)
            if n:
                return n
        return 0
    return stacked.shape[0] if isinstance(stacked, torch.Tensor) else 0


class _Stages:
    """This rank's stage of the `axis_name` axis of `mesh` and the GPipe
    schedule over it, `microbatches` (default: the stage count) a batch."""

    def __init__(self, mesh, axis_name: str = 'pp',
                 microbatches: Optional[int] = None):
        self.n = mesh.shape.get(axis_name, 1)
        self.index = mesh.index(axis_name)
        self.group = mesh.group(axis_name)
        self.ranks = self.group[1] if self.group is not None else None
        self.microbatches = microbatches or self.n

    def run(self, x: torch.Tensor, body: Callable) -> torch.Tensor:
        """x: the (B, ...) stage-0 input, the same on every rank. body(h,
        part, rows) -> h runs this stage's layers on microbatch `part`, the
        batch rows `rows` (a slice). Returns the last stage's (B, ...)
        output on every rank of the axis."""
        M, S, s = self.microbatches, self.n, self.index
        B = x.shape[0]
        assert B % M == 0, f'batch {B} not divisible by {M} microbatches'
        mb = B // M
        x = x.contiguous()
        out = torch.empty_like(x)
        buf = torch.empty_like(x[:mb])
        for t in range(M + S - 1):
            part = t - s                  # the microbatch at this stage now
            if not 0 <= part < M:
                continue
            rows = slice(part * mb, (part + 1) * mb)
            h = x[rows] if s == 0 else recv(buf, self.ranks[s - 1]).clone()
            y = body(h, part, rows)
            if s + 1 < S:
                send(y.contiguous(), self.ranks[s + 1])
            else:
                out[rows] = y
        if self.group is not None:
            broadcast(out, self.group, src=S - 1)
        return out


def pipeline_forward(stacked_params, x: torch.Tensor, block_fn: Callable,
                     mesh, axis_name: str = 'pp',
                     microbatches: Optional[int] = None) -> torch.Tensor:
    """Run x through all stacked layers, pipelined over `axis_name`.

    stacked_params: the global tree with a leading layer axis L (divisible
    by the stage count); each rank runs its stage's L / S layers. x: the
    global (B, ...) input, the same on every rank, with B divisible by
    `microbatches` (default: the stage count). block_fn(layer_params, x)
    -> x applies ONE layer. Returns the (B, ...) output on every rank."""
    stages = _Stages(mesh, axis_name, microbatches)
    L = _n_layers(stacked_params)
    assert L % stages.n == 0, f'{L} layers do not split over {stages.n} stages'
    per = L // stages.n
    local = _stage_slice(stacked_params, stages.index * per,
                         (stages.index + 1) * per)

    def apply_stage(h, part, rows):
        for i in range(per):
            h = block_fn(_layer(local, i), h)
        return h
    return stages.run(x, apply_stage)


# ============================================================= sp helpers ==

def _sp_axis(mesh) -> int:
    """Size of the mesh's optional 'sp' axis (1: none)."""
    return 1 if mesh is None else mesh.shape.get('sp', 1)


def _sp_block_offset(mesh, nb_local: int) -> int:
    """This sp shard's first global pool row within its dp row (block axis
    sharded 'sp')."""
    return mesh.index('sp') * nb_local


def _sp_merge_triple(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     groups):
    """Exact merge of partial-softmax triples over disjoint key sets, one
    set a rank, over each group of `groups` in turn (None: a one-rank axis):
    the max m_g of m over the group, weights w = exp(m - m_g), and the sums
    of acc * w and l * w. A rank that holds none of a row's keys (m = -1e30,
    l = 0, acc = 0) weighs 0; a row no rank holds stays empty. acc
    (..., Dh), m and l (...). Every rank gets the same bits."""
    for group in groups:
        if group is None:
            continue
        m_g = all_reduce(m.clone(), group, 'max')
        w = torch.exp(m - m_g)
        packed = torch.cat([acc * w[..., None], (l * w)[..., None]], dim=-1)
        all_reduce(packed, group)
        acc, m, l = packed[..., :-1], m_g, packed[..., -1]
    return acc, m, l


# ========================================================= serving stages ==
# The cache-ful serving forwards on a 'pp' mesh: the one-card functions
# (serving/model.py, serving/paged.py) on this rank's stage, their layer
# loop run on the stage's microbatches by `_Stages`. `params` are a rank's
# parameters (its stage's layers, `tensor_parallel.shard_llama_params`),
# and the cache or pools hold those layers' slabs; the tokens and every
# other input are the global ones, the same on every rank. The JAX package
# runs every stage on every tick, its bubbles on zeros; here a stage runs
# its busy ticks only.

def forward_staged(params: Dict, cache: Dict, tokens, positions, write_pos,
                   seq_lens, cfg, mesh, axis_name: str = 'pp',
                   microbatches: Optional[int] = None, active=None):
    """`model.forward` staged over `axis_name` (the dense prefill and
    single step of a 'pp' engine; on a pp x sp mesh the stage's cache holds
    its positions, `model.seq_shard`). Returns (logits (B, T, vocab) f32 on
    every rank, the cache, updated in place)."""
    from .model import forward
    return forward(params, cache, tokens, positions, write_pos, seq_lens,
                   cfg, active=active, sp_mesh=_sp_mesh(mesh),
                   stages=_Stages(mesh, axis_name, microbatches))


def burst_forward_staged(params: Dict, cache: Dict, tokens, seq_lens,
                         n_steps: int, cfg, mesh, axis_name: str = 'pp',
                         select_fn=None, microbatches: Optional[int] = None,
                         **kw):
    """n decode steps on a 'pp' mesh with each stage's slabs frozen:
    `model.burst_forward` on the stage's layers, its in-burst buffers,
    bank write (row 14) each step and window write (row 15) at the end
    (`kw`: its read options). Returns (toks (n, B), the cache)."""
    from .model import burst_forward
    return burst_forward(params, cache, tokens, seq_lens, n_steps, cfg,
                         select_fn, sp_mesh=_sp_mesh(mesh),
                         stages=_Stages(mesh, axis_name, microbatches), **kw)


def _sp_mesh(mesh):
    """The mesh a staged path passes on where the cache's sequence axis or
    the pools' block axis is sharded too (pp x sp), else None."""
    return mesh if _sp_axis(mesh) > 1 else None


def prefill_staged_paged(params: Dict, pools: Dict, tokens, lengths, tables,
                         active, cfg, mesh, axis_name: str = 'pp',
                         microbatches: Optional[int] = None):
    """`paged.prefill_paged` staged: each stage writes its layers' K/V into
    its pools (row 16) at the end. Returns (logits (B, T, vocab) f32,
    pools)."""
    from .paged import prefill_paged
    return prefill_paged(params, pools, tokens, lengths, tables, active, cfg,
                         sp_mesh=_sp_mesh(mesh),
                         stages=_Stages(mesh, axis_name, microbatches))


def burst_forward_staged_paged(params: Dict, pools: Dict, tokens, seq_lens,
                               tables, n_steps: int, cfg, mesh,
                               axis_name: str = 'pp', select_fn=None,
                               microbatches: Optional[int] = None, **kw):
    """`paged.burst_forward_paged` staged: each stage repacks its layers'
    frozen window (a microbatch at a time) and reads it through row 12, on
    a pp x sp mesh its shard's blocks merged over 'sp'; one pool write a
    burst (row 16). The JAX package reads through `paged_decode_xla` and
    writes through `scatter_kv_all` here (recorded difference 55).
    Returns (toks (n, B), pools)."""
    from .paged import burst_forward_paged
    return burst_forward_paged(params, pools, tokens, seq_lens, tables,
                               n_steps, cfg, select_fn,
                               sp_mesh=_sp_mesh(mesh),
                               stages=_Stages(mesh, axis_name, microbatches),
                               **kw)


def prefill_chunk_staged_paged(params: Dict, pools: Dict, tokens, write_pos,
                               tables, active, prefix_blocks: int, cfg, mesh,
                               axis_name: str = 'pp',
                               microbatches: Optional[int] = None):
    """`paged.prefill_chunk_paged` staged: the prefix gather is the
    stage's own (on a pp x sp mesh rebuilt over 'sp'). Returns (logits
    (B, chunk, vocab) f32, pools)."""
    from .paged import prefill_chunk_paged
    return prefill_chunk_paged(params, pools, tokens, write_pos, tables,
                               active, prefix_blocks, cfg,
                               sp_mesh=_sp_mesh(mesh),
                               stages=_Stages(mesh, axis_name, microbatches))
