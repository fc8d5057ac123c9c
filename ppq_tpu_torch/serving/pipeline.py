"""Pipeline parallelism: the GPipe staged forward over a mesh axis.

Counterpart of `ppq_tpu/serving/pipeline.py:28-95`. The layers partition
into stages over the 'pp' axis, each rank holding its stage's slice of the
stacked layer parameters. Microbatches stream through the stages: at tick
t stage s runs microbatch t - s (M + S - 1 ticks in all, bubbles at fill
and drain) and sends its output to stage s + 1; the last stage's outputs
are broadcast to every rank of the axis. A stage computes only on its
busy ticks (the JAX package runs every stage every tick on zeros).

The cache-ful serving forwards (`forward_staged` and the staged paged
paths, `pipeline.py:97` on) are item 15b.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..parallel.multihost import broadcast, recv, send


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


def pipeline_forward(stacked_params, x: torch.Tensor, block_fn: Callable,
                     mesh, axis_name: str = 'pp',
                     microbatches: Optional[int] = None) -> torch.Tensor:
    """Run x through all stacked layers, pipelined over `axis_name`.

    stacked_params: the global tree with a leading layer axis L (divisible
    by the stage count); each rank runs its stage's L / S layers. x: the
    global (B, ...) input, the same on every rank, with B divisible by
    `microbatches` (default: the stage count). block_fn(layer_params, x)
    -> x applies ONE layer. Returns the (B, ...) output on every rank."""
    S = mesh.shape.get(axis_name, 1)
    M = microbatches or S
    B = x.shape[0]
    assert B % M == 0, f'batch {B} not divisible by {M} microbatches'
    L = _n_layers(stacked_params)
    assert L % S == 0, f'{L} layers do not split over {S} stages'
    s = mesh.index(axis_name)
    group = mesh.group(axis_name)
    ranks = group[1] if group is not None else None
    per = L // S
    local = _stage_slice(stacked_params, s * per, (s + 1) * per)
    x_mb = x.reshape((M, B // M) + tuple(x.shape[1:]))

    def apply_stage(h):
        for i in range(per):
            h = block_fn(_layer(local, i), h)
        return h

    out = torch.zeros_like(x_mb)
    buf = torch.empty_like(x_mb[0])
    for t in range(M + S - 1):
        mb = t - s                     # the microbatch at this stage now
        if not 0 <= mb < M:
            continue
        if s == 0:
            h = x_mb[mb]
        else:
            h = recv(buf, ranks[s - 1]).clone()
        y = apply_stage(h)
        if s + 1 < S:
            send(y.contiguous(), ranks[s + 1])
        else:
            out[mb] = y
    # every rank of the axis takes the last stage's outputs
    if group is not None:
        broadcast(out, group, src=S - 1)
    return out.reshape((B,) + tuple(x.shape[1:]))
