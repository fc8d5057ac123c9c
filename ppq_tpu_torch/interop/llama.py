"""Carry a serving parameter tree or KV cache across from the JAX package,
as numpy arrays.

The JAX package's tree (`embed`, `final_norm`, `lm_head`, `layers[i]` with
`w_int` / `w_packed` / `scale` / `w` leaves, fused or not, and a MoE
layer's `moe` dict: the `router` and the stacked expert `w_int` / `scale`
or `w`) maps leaf for leaf onto the port's dictionaries of tensors; a
packed INT4 leaf crosses as its int8 bytes, and a Python number (an
unpopped `top_k` / `n_experts`) stays a number. numpy has no bfloat16:
bf16 leaves (`embed`, `w`, a 16-bit cache's `k` / `v`) cross as float32,
which holds every bf16 value exactly, and are rounded back on arrival.
"""

from __future__ import annotations

import numpy as np
import torch

from ..executor.executor import resolve_device

# leaves the packages keep in bfloat16
_BF16_LEAVES = ('embed', 'w')


def _walk(tree, leaf, key=None):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, leaf, key) for v in tree]
    if isinstance(tree, (bool, int, float)):
        return tree
    return leaf(key, tree)


def llama_params_from_numpy(params, device=None):
    """A tree of numpy arrays -> the port's parameter tree on `device` (the
    card unless named)."""
    device = resolve_device(device)

    def leaf(key, value):
        t = torch.from_numpy(np.ascontiguousarray(value)).to(device)
        return t.to(torch.bfloat16) if key in _BF16_LEAVES else t
    return _walk(params, leaf)


def llama_params_to_numpy(params):
    """The port's parameter tree -> numpy arrays (bf16 leaves as float32)."""
    def leaf(key, value):
        if value.dtype == torch.bfloat16:
            value = value.to(torch.float32)
        return value.detach().cpu().numpy()
    return _walk(params, leaf)


def kv_cache_from_numpy(cache, device=None):
    """A KV cache of numpy arrays (`k`, `v` int8 with `k_scale`, `v_scale`,
    or float32 `k`, `v` of a 16-bit cache) -> tensors on `device` (the card
    unless named)."""
    device = resolve_device(device)
    out = {}
    for key, value in cache.items():
        t = torch.from_numpy(np.ascontiguousarray(value)).to(device)
        if key in ('k', 'v') and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        out[key] = t
    return out


def kv_cache_to_numpy(cache):
    return {key: (value.to(torch.float32) if value.dtype == torch.bfloat16
                  else value).detach().cpu().numpy()
            for key, value in cache.items()}


def paged_pools_from_numpy(pools, device=None):
    """Paged KV pools of numpy arrays (`kv` (L, NB, 2, BLK, KV*Dh) int8 with
    `kv_scale` (L, NB, 2, KV, BLK), or a float32 `kv` of a 16-bit cache) ->
    tensors on `device` (the card unless named)."""
    device = resolve_device(device)
    out = {}
    for key, value in pools.items():
        t = torch.from_numpy(np.ascontiguousarray(value)).to(device)
        if key == 'kv' and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        out[key] = t
    return out


def paged_pools_to_numpy(pools):
    return {key: (value.to(torch.float32) if value.dtype == torch.bfloat16
                  else value).detach().cpu().numpy()
            for key, value in pools.items()}


def block_allocator_from(alloc):
    """A port BlockAllocator in the state of the JAX package's Python one
    (duck-typed: its `free`, `slot_blocks` and `_refs`), so that tables,
    free list and reference counts carry over with the pools. The result
    runs the Python free list: the native allocator's state cannot be set
    from outside."""
    from ..serving.paged import BlockAllocator
    out = BlockAllocator(alloc.num_blocks, alloc.max_batch,
                         alloc.max_blocks_per_seq, alloc.block_size,
                         native=False)
    out.free = [int(b) for b in alloc.free]
    out.slot_blocks = [[int(b) for b in blocks] for blocks in alloc.slot_blocks]
    out._refs = [int(r) for r in alloc._refs]
    return out
