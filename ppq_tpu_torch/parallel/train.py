"""Sharded quantization-aware training step (dp x tp over a mesh).

Counterpart of `ppq_tpu/parallel/train.py`. There XLA partitions the whole
step from the shardings alone. Here the step is partitioned by hand
(recorded difference 53):
  * the batch is split over 'dp': each rank runs the compiled trainable
    forward (`CompiledGraph.build_trainable_forward`, rows 1, 2, 4 and 5 of
    the kernel table on the card) on its dp shard;
  * a weight that `_tp_axis_for` shards is stored as the rank's 'tp' slice
    and gathered over 'tp' for the forward; the ranks of one tp line hold
    the same batch rows, so each keeps its slice of the full gradient;
  * gradients are summed over 'dp' with the loss normalised by the global
    batch, which gives the mean over the global batch;
  * Adam (optax's defaults) updates each rank's shards and the replicated
    tensors alike; an all-reduce gives every rank the same bits, so the
    replicas stay equal.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..executor.compile import CompiledGraph
from ..executor.ops.default import simulation_precision
from .mesh import batch_sharding, tp_param_shardings
from .multihost import all_gather, all_reduce, world_device


class _GatherOverTP(torch.autograd.Function):
    """A weight's full value from the tp ranks' slices; the backward keeps
    this rank's slice of the full gradient (every rank of the line computed
    the same one)."""

    @staticmethod
    def forward(ctx, local, group, dim, index):
        ctx.dim, ctx.index, ctx.size = dim, index, local.shape[dim]
        return all_gather(local.detach(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
        return part.contiguous(), None, None, None


def make_sharded_train_step(cg: CompiledGraph, mesh, lr: float = 1e-4,
                            train_weights: bool = True,
                            train_scales: bool = True
                            ) -> Tuple[Callable, Dict]:
    """A dp x tp training step minimizing the MSE between the quantized
    forward and given fp32 target outputs.

    Returns (step, state) where
      step(state, batch, target) -> (state, loss)
      state = {'trainable', 'frozen', 'opt'}
    `batch` and `target` are this rank's dp shards (`shard_batch`); the
    loss is the global batch's mean, the same on every rank. The state's
    sharded weights are this rank's slices."""
    fwd = cg.build_trainable_forward()
    input_name = list(cg.graph.inputs.keys())[0]
    params = cg.init_params()
    qparams = cg.init_qparams()
    p_shard = tp_param_shardings(params, mesh)
    tp, dp = mesh.group('tp'), mesh.group('dp')
    tp_index = mesh.index('tp')
    axis = {k: (s.spec.index('tp') if 'tp' in s.spec else None)
            for k, s in p_shard.items()}

    def leaf(v, trainable):
        return v.detach().clone().contiguous().requires_grad_(trainable)
    local = {k: leaf(p_shard[k].local(v), train_weights)
             for k, v in params.items()}
    # quant scales and offsets are replicated (`shard_qparams`)
    q = {k: {kk: leaf(vv, train_scales) for kk, vv in v.items()}
         for k, v in qparams.items()}
    trainable, frozen, tensors = {}, {}, []
    (trainable if train_weights else frozen)['params'] = local
    (trainable if train_scales else frozen)['qparams'] = q
    if train_weights:
        tensors += list(local.values())
    if train_scales:
        tensors += [t for pair in q.values() for t in pair.values()]
    opt = torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8) \
        if tensors else None
    dp_size = mesh.shape.get('dp', 1)

    def full_params():
        return {k: (v if axis[k] is None or tp is None else
                    _GatherOverTP.apply(v, tp, axis[k], tp_index))
                for k, v in local.items()}

    def step(state, x, target):
        if opt is not None:
            opt.zero_grad(set_to_none=True)
        out = fwd(full_params(), q, {input_name: x})[0].to(torch.float32)
        target = target.to(out.device, torch.float32)
        # the global batch's mean: this rank's sum over every rank's count
        loss = torch.sum((out - target) ** 2) / (out.numel() * dp_size)
        if opt is not None:
            with simulation_precision():    # no TF32 in the backward
                loss.backward()
            grads = [torch.zeros_like(t) if t.grad is None else t.grad
                     for t in tensors]
            # one reduction for every gradient
            flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), dp)
            for t, part in zip(tensors, flat.split([g.numel()
                                                    for g in grads])):
                t.grad = part.view_as(t)
            opt.step()
        total = all_reduce(loss.detach().clone(), dp)
        return state, total

    state = {'trainable': trainable, 'frozen': frozen, 'opt': opt}
    step.full_params = full_params
    return step, state


def shard_batch(mesh, x, device=None) -> torch.Tensor:
    """This rank's dp shard of a host batch, on `device` (the world's
    unless named)."""
    t = torch.as_tensor(x)
    return batch_sharding(mesh, t.dim()).local(t).contiguous() \
        .to(device if device is not None else world_device())
