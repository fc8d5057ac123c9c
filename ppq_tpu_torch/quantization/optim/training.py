"""Training-based optimization passes: bias correction, LSQ, AdaRound
(port of ppq_tpu/quantization/optim/training.py, itself a redesign of
ppq/quantization/optim/training.py + legacy.py).

All finetuning is blockwise (BlockBuilder). A block runs through the
executor's `partial_graph_forward` with the autograd graph recorded: the
fake-quant sites are `torch.autograd.Function`s over the hand-written forward
and backward kernels (quantization/qfunction.py), trainable scales and
offsets are `nn.Parameter`s held by one `TrainableQuantDelegator` per root
TQC, weights are leaf tensors handed to the executor as parameter overrides,
and the optimizer is `torch.optim.Adam`. The IR keeps its values until a
block's result is accepted.

Protocol per block (reference training.py:569-864):
  1. cache the fp32 reference outputs of ALL blocks over the calibration
     set in one sweep, and each block's quantized inputs just before that
     block is trained, so that they carry what the blocks before it have
     learned (the caches stay on the executor's device);
  2. optimize {weights, quant scales} (LSQ) or {rounding direction}
     (AdaRound) against MSE to the fp32 outputs;
  3. accept the update only if the block loss improved (check/rollback,
     reference TrainingBasedPass.check training.py:62-120).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core import COMPUTING_OP, QuantizationStates, ppq_info
from ...executor.executor import QuantizeDelegator
from ...executor.ops.default import simulation_precision
from ...ir import (BaseGraph, QuantableOperation, dequantize_graph,
                   restore_graph_quantization, soi_input_indices)
from ..algorithm.blocks import BlockBuilder, TrainableBlock
from ..qfunction import (dynamic_linear_fake_quant, floating_fake_quant,
                         linear_fake_quant)
from .base import QuantizationOptimizationPass

Cache = List[Dict[str, torch.Tensor]]


def _batches(dataloader, collate_fn, limit):
    n = 0
    for batch in dataloader:
        if collate_fn is not None:
            batch = collate_fn(batch)
        yield batch
        n += 1
        if n >= limit:
            break


class _unbaked_parameters:
    """Context: temporarily restore BAKED/PASSIVE_BAKED parameters to their
    fp32 values with live (ACTIVATED/PASSIVE) configs, re-baking on exit.

    Training passes may legally run after ParameterBakingPass (manop flows);
    training must see quantization applied at runtime — and any weight the
    pass writes must flow into the fp32 shadows so exporters re-quantize
    the *trained* values (stale shadows broke the deploy==sim guarantee).
    """

    def __init__(self, graph: BaseGraph):
        self.graph = graph
        self.had_baked = False

    def __enter__(self):
        for op in self.graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            for var, cfg in zip(op.inputs,
                                op.config.input_quantization_config):
                if not var.is_parameter:
                    continue
                if cfg.state == QuantizationStates.BAKED:
                    if var.name in op._fp32_params:
                        var.value = np.array(op._fp32_params[var.name],
                                             copy=True)
                    cfg.state = QuantizationStates.ACTIVATED
                    self.had_baked = True
                elif cfg.state == QuantizationStates.PASSIVE_BAKED:
                    if var.name in op._fp32_params:
                        var.value = np.array(op._fp32_params[var.name],
                                             copy=True)
                    cfg.state = QuantizationStates.PASSIVE
                    self.had_baked = True
        return self

    def __exit__(self, *exc):
        if self.had_baked:
            from .baking import ParameterBakingPass
            ParameterBakingPass().optimize(self.graph)


def _sync_fp32_shadow(graph: BaseGraph, var_name: str, value: np.ndarray):
    """Write a trained parameter into the IR and its owners' fp32 shadows.
    The IR gets a new array, so an executor's upload cache sees the change."""
    var = graph.variables[var_name]
    var.value = np.array(value, copy=True)
    for dest in var.dest_ops:
        if isinstance(dest, QuantableOperation) and \
                var_name in dest._fp32_params:
            dest._fp32_params[var_name] = np.array(var.value, copy=True)


def _is_trainable_cfg(cfg) -> bool:
    root = cfg.dominated_by
    return root.state in {QuantizationStates.ACTIVATED,
                          QuantizationStates.PASSIVE} and root.has_scale


class TrainableQuantDelegator(torch.nn.Module, QuantizeDelegator):
    """The scale and offset of one root TQC as `nn.Parameter`s, applied at
    every quant site that resolves to that root (executor/compile.py
    `init_qparams` / `_apply_quant` in the JAX package). Under training the
    offset of a symmetric TQC is a parameter too, and a floating TQC is
    tensorwise."""

    def __init__(self, root, device, trainable: bool):
        super().__init__()
        self.root = root
        self.scale = torch.nn.Parameter(
            torch.as_tensor(np.asarray(root.scale, np.float32),
                            device=device).clone(), requires_grad=trainable)
        self.offset = torch.nn.Parameter(
            torch.as_tensor(np.asarray(root.offset, np.float32),
                            device=device).clone(), requires_grad=trainable)

    def forward(self, tensor, config):
        if not isinstance(tensor, torch.Tensor) or \
                not tensor.is_floating_point() or not config.is_active:
            return tensor
        tensor = tensor.contiguous()
        axis = config.channel_axis if config.policy.per_channel else None
        if config.policy.dynamic:
            return dynamic_linear_fake_quant(
                tensor, config.quant_min, config.quant_max,
                symmetric=config.policy.symmetric, rounding=config.rounding,
                channel_axis=axis)
        if config.policy.floating:
            return floating_fake_quant(
                tensor, self.scale, config.exponent_bits,
                config.num_of_bits - 1 - config.exponent_bits,
                config.quant_min, config.quant_max)
        return linear_fake_quant(
            tensor, self.scale, self.offset, config.quant_min,
            config.quant_max, config.rounding, axis)

    def write_back(self):
        """Push the trained scale and offset onto the root TQC."""
        self.root.scale = self.scale.detach().cpu().numpy()
        self.root.offset = self.offset.detach().cpu().numpy()


class BlockRuntime:
    """One block, ready to run and to train on an executor: the block's
    float parameters as tensors on the executor's device, and one
    TrainableQuantDelegator per root TQC, registered for every quant site of
    the block that resolves to it. Use as a context manager; the delegates
    are removed on exit."""

    def __init__(self, executor, block: TrainableBlock,
                 output_names: Optional[List[str]] = None,
                 scales_trainable: bool = False):
        self.executor = executor
        self.block = block
        self.output_names = list(output_names or block.output_names)
        self.device = executor.device
        self.delegators: Dict[object, TrainableQuantDelegator] = {}
        self._registered = []
        for op in block.rps:
            if not isinstance(op, QuantableOperation):
                continue
            for cfg in op.config:
                root = cfg.dominated_by
                if not _is_trainable_cfg(root):
                    continue
                if root not in self.delegators:
                    self.delegators[root] = TrainableQuantDelegator(
                        root, self.device, scales_trainable)
                executor.register_quantize_delegate(cfg, self.delegators[root])
                self._registered.append(cfg)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for cfg in self._registered:
            self.executor.remove_quantize_delegate(cfg)
        self._registered = []

    def parameters(self) -> Dict[str, torch.Tensor]:
        """The block's float parameters, copied to the device (parameters at
        shape and index slots stay with the IR)."""
        soi_vars = set()
        for op in self.block.rps:
            for idx in soi_input_indices(op):
                if idx < len(op.inputs):
                    soi_vars.add(op.inputs[idx].name)
        out = {}
        for op in self.block.rps:
            for var in op.inputs:
                if not var.is_parameter or not var.has_value or \
                        var.name in soi_vars or var.name in out:
                    continue
                value = np.asarray(var.value)
                if np.issubdtype(value.dtype, np.floating):
                    out[var.name] = torch.tensor(
                        value.astype(np.float32, copy=False),
                        device=self.device)
        return out

    def qparams(self) -> List[torch.nn.Parameter]:
        return [p for d in self.delegators.values() for p in (d.scale, d.offset)]

    def run(self, params: Dict[str, torch.Tensor],
            feed: Dict[str, torch.Tensor],
            with_gradient: bool = False) -> List[torch.Tensor]:
        return self.executor.partial_graph_forward(
            self.block.rps, {n: feed[n] for n in self.block.input_names},
            self.output_names, with_gradient=with_gradient, parameters=params)

    def loss(self, outs, targets: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Sum over the block's outputs of the mean squared error."""
        total = 0.0
        for name, out in zip(self.output_names, outs):
            if name in self.block.output_names:
                total = total + torch.mean((out - targets[name]) ** 2)
        return total

    def write_back_qparams(self):
        for delegator in self.delegators.values():
            delegator.write_back()


class TrainingBasedPass(QuantizationOptimizationPass):
    """Shared machinery (reference optim/training.py:18)."""

    def __init__(self, name: str, block_size: int = 4, steps: int = 500,
                 lr: float = 1e-4, calib_steps: int = 8):
        super().__init__(name)
        self.block_size = block_size
        self.steps = steps
        self.lr = lr
        self.calib_steps = calib_steps
        # one entry per block of the last optimize(): the losses and what
        # was decided
        self.history: List[dict] = []

    def _record(self, what: str, block, pre_loss: float, post_loss: float):
        accepted = post_loss < pre_loss
        self.history.append(dict(block=repr(block), pre_loss=pre_loss,
                                 post_loss=post_loss, accepted=accepted))
        ppq_info(f'{what} {block}: loss {pre_loss:.3e} → {post_loss:.3e} '
                 f'({"accepted" if accepted else "rolled back"})')
        return accepted

    # ---------------------------------------------------------- data caches
    @staticmethod
    def collect_inputs(graph: BaseGraph, blocks: List[TrainableBlock],
                       batches, executor) -> Cache:
        """One sweep of the graph as it stands: the quantized value of every
        block input, per batch, on the executor's device."""
        in_names = sorted({n for b in blocks for n in b.input_names})
        return [dict(zip(in_names, executor.forward(b, in_names)))
                for b in batches]

    @staticmethod
    def collect_targets(graph: BaseGraph, blocks: List[TrainableBlock],
                        batches, executor) -> Cache:
        """One sweep of the dequantized graph: the fp32 value of every block
        output, per batch, on the executor's device."""
        out_names = sorted({n for b in blocks for n in b.output_names})
        # fp32 reference: disable quantization graph-wide, run, restore
        dequantize_graph(graph)
        try:
            return [dict(zip(out_names, executor.forward(b, out_names)))
                    for b in batches]
        finally:
            restore_graph_quantization(graph)

    def collect_caches(self, graph: BaseGraph, blocks: List[TrainableBlock],
                       dataloader, collate_fn, executor
                       ) -> Tuple[Cache, Cache]:
        """Both sweeps: (quantized block inputs, fp32 block targets)."""
        batches = list(_batches(dataloader, collate_fn, self.calib_steps))
        return (self.collect_inputs(graph, blocks, batches, executor),
                self.collect_targets(graph, blocks, batches, executor))

    def _tune_blockwise(self, graph, blocks, dataloader, collate_fn, executor,
                        tune):
        """tune(graph, executor, block, inputs, targets) for every block in
        order. The fp32 targets of all blocks are taken once, before any
        block changes. A block's quantized inputs are taken just before it
        is tuned: inputs cached before the earlier blocks were tuned would
        teach a block to undo error that those blocks have since removed
        (on a full-width ResNet-18 that made LSQ worsen the output against
        the fp32 model ninefold while every block improved)."""
        batches = list(_batches(dataloader, collate_fn, self.calib_steps))
        targets = self.collect_targets(graph, blocks, batches, executor)
        for block in blocks:
            inputs = self.collect_inputs(graph, [block], batches, executor)
            tune(graph, executor, block, inputs, targets)

    @staticmethod
    def block_loss(runtime: BlockRuntime, params, qt_cache: Cache,
                   fp_cache: Cache) -> float:
        total = torch.zeros((), device=runtime.device)
        for qt, fp in zip(qt_cache, fp_cache):
            total = total + runtime.loss(runtime.run(params, qt), fp)
        return float(total) / max(len(qt_cache), 1)


def _require(executor, dataloader, what: str):
    if dataloader is None:
        raise ValueError(f'{what} requires a dataloader')
    if executor is None:
        raise ValueError(f'{what} requires an executor: it trains on the '
                         f"executor's device")


class LearnedStepSizePass(TrainingBasedPass):
    """Blockwise LSQ finetuning (reference optim/training.py:569;
    Esser et al.). Trains weights and (optionally) quant scales of each
    block to minimize MSE vs the fp32 reference."""

    def __init__(self, block_size: int = 4, lr: float = 1e-5,
                 steps: int = 500, gamma: float = 0.0,
                 is_scale_trainable: bool = True, calib_steps: int = 8):
        super().__init__('Learned Step Size Pass (LSQ)', block_size, steps,
                         lr, calib_steps)
        self.gamma = gamma
        self.is_scale_trainable = is_scale_trainable

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        _require(executor, dataloader, 'LSQ')
        self.history = []
        blocks = BlockBuilder(graph).build(self.block_size)
        if not blocks:
            return
        with _unbaked_parameters(graph):
            self._tune_blockwise(graph, blocks, dataloader, collate_fn,
                                 executor, self._finetune_block)

    def _finetune_block(self, graph, executor, block, qt_cache, fp_cache):
        with BlockRuntime(executor, block,
                          scales_trainable=self.is_scale_trainable) as runtime:
            params = runtime.parameters()
            if not params and not runtime.delegators:
                return
            pre_loss = self.block_loss(runtime, params, qt_cache, fp_cache)
            for value in params.values():
                value.requires_grad_(True)
            trainable = list(params.values())
            if self.is_scale_trainable:
                trainable += runtime.qparams()
            opt = torch.optim.Adam(trainable, lr=self.lr, betas=(0.9, 0.999),
                                   eps=1e-8)
            n_cache = len(qt_cache)
            for it in range(self.steps):
                qt, fp = qt_cache[it % n_cache], fp_cache[it % n_cache]
                opt.zero_grad(set_to_none=True)
                loss = runtime.loss(
                    runtime.run(params, qt, with_gradient=True), fp)
                with simulation_precision():    # no TF32 in the backward
                    loss.backward()
                opt.step()
            for value in params.values():
                value.requires_grad_(False)
            post_loss = self.block_loss(runtime, params, qt_cache, fp_cache)
            # accept (reference check, training.py:115)
            if self._record('LSQ', block, pre_loss, post_loss):
                for name, value in params.items():
                    _sync_fp32_shadow(graph, name, value.cpu().numpy())
                if self.is_scale_trainable:
                    runtime.write_back_qparams()


class BiasCorrectionPass(TrainingBasedPass):
    """Blockwise bias correction (reference optim/training.py:338):
    per block, shift each computing op's bias by the channel mean of
    [dequantized-block output − quantized-block output], BOTH evaluated
    on the QUANTIZED net's block inputs — the correction targets the
    error the block itself introduces, not the accumulated upstream
    error (a whole-net fp32-vs-quant comparison double-counts: every
    downstream op's correction re-absorbs upstream error that upstream
    corrections already fixed). Corrections are kept only if the
    block's MSE against the fp32 reference improves (reference
    check/rollback, training.py:521-526)."""

    def __init__(self, block_size: int = 4, steps: int = 32,
                 calib_steps: Optional[int] = None):
        super().__init__('Bias Correction Pass', block_size, steps,
                         0.0, calib_steps or min(steps, 16))

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        _require(executor, dataloader, 'BiasCorrection')
        self.history = []
        blocks = BlockBuilder(graph).build(self.block_size)
        if not blocks:
            return
        with _unbaked_parameters(graph):
            # the caches are refreshed per block: they must see the biases
            # corrected so far (the reference re-collects per block,
            # training.py:556)
            batches = list(_batches(dataloader, collate_fn, self.calib_steps))
            for block in blocks:
                qt_cache, fp_cache = self.collect_caches(
                    graph, [block], batches, None, executor)
                self._correct_block(graph, executor, block, qt_cache,
                                    fp_cache)

    @staticmethod
    def _channel_mean(v: torch.Tensor, op_type: str) -> torch.Tensor:
        # Conv/ConvTranspose add bias on axis 1; Gemm on the last axis
        # (reference collect_bias, training.py:438-448)
        axis = 1 if op_type in ('Conv', 'ConvTranspose') else v.ndim - 1
        dims = [i for i in range(v.ndim) if i != axis]
        return v.to(torch.float64).mean(dim=dims)

    def _correct_block(self, graph, executor, block, qt_cache, fp_cache):
        targets = [op for op in block.rps
                   if isinstance(op, QuantableOperation)
                   and op.type in ('Conv', 'ConvTranspose', 'Gemm')
                   and len(op.inputs) == 3
                   and op.inputs[-1].is_parameter]
        if not targets:
            return
        t_outs = [op.outputs[0].name for op in targets]
        names = list(dict.fromkeys(list(block.output_names) + t_outs))
        with BlockRuntime(executor, block, output_names=names) as runtime:
            params = runtime.parameters()
            qt_vals = [runtime.run(params, qt) for qt in qt_cache]
        # the fp term: the same block, on the same inputs, dequantized
        for op in block.rps:
            if isinstance(op, QuantableOperation):
                op.dequantize(parameter_only=False)
        try:
            fp_vals = [executor.partial_graph_forward(
                block.rps, {n: qt[n] for n in block.input_names}, names)
                for qt in qt_cache]
        finally:
            for op in block.rps:
                if isinstance(op, QuantableOperation):
                    op.restore_quantize_state()

        corrections = {}
        for op in targets:
            idx = names.index(op.outputs[0].name)
            errs = [self._channel_mean(f[idx], op.type)
                    - self._channel_mean(q[idx], op.type)
                    for f, q in zip(fp_vals, qt_vals)]
            corrections[op.inputs[-1].name] = torch.stack(errs).mean(dim=0)

        with BlockRuntime(executor, block, output_names=names) as runtime:
            pre_loss = float(sum(runtime.loss(outs, fp) for outs, fp in
                                 zip(qt_vals, fp_cache))) / max(len(qt_vals), 1)
            params_new = dict(params)
            for bname, err in corrections.items():
                if bname in params_new:
                    params_new[bname] = params_new[bname] + \
                        err.to(params_new[bname].dtype)
            post_loss = self.block_loss(runtime, params_new, qt_cache,
                                        fp_cache)
        # accept (reference training.py:521)
        if self._record('BiasCorrection', block, pre_loss, post_loss):
            for bname, err in corrections.items():
                var = graph.variables[bname]
                _sync_fp32_shadow(
                    graph, bname,
                    (np.asarray(var.value, np.float64)
                     + err.cpu().numpy()).astype(np.float32))


class AdaroundPass(TrainingBasedPass):
    """Blockwise AdaRound (reference optim/legacy.py:138; Nagel et al.):
    learn each weight element's rounding direction h ∈ {0,1} by optimizing
    a rectified-sigmoid soft rounding variable against block MSE + a
    regularizer annealing h to binary."""

    ZETA, GAMMA = 1.1, -0.1

    def __init__(self, block_size: int = 4, steps: int = 1000,
                 lr: float = 1e-3, gamma: float = 1.0, beta_anneal=(20.0, 2.0),
                 calib_steps: int = 8):
        super().__init__('AdaRound Pass', block_size, steps, lr, calib_steps)
        self.reg_gamma = gamma
        self.beta_anneal = beta_anneal

    # h(v) = clip(sigmoid(v)(zeta-gamma)+gamma, 0, 1)
    @classmethod
    def _h(cls, v: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.sigmoid(v) * (cls.ZETA - cls.GAMMA)
                           + cls.GAMMA, 0.0, 1.0)

    @classmethod
    def _init_v(cls, frac):
        frac = np.clip(frac, 1e-4, 1 - 1e-4)
        p = (frac - cls.GAMMA) / (cls.ZETA - cls.GAMMA)
        return np.log(p / (1 - p)).astype(np.float32)

    @staticmethod
    def _weight_targets(block) -> List[Tuple[QuantableOperation, int]]:
        out = []
        for op in block.rps:
            if not isinstance(op, QuantableOperation):
                continue
            if op.type not in COMPUTING_OP:
                continue
            if len(op.inputs) < 2:
                continue
            cfg = op.config.input_quantization_config[1]
            if cfg.state == QuantizationStates.ACTIVATED and cfg.has_scale:
                out.append((op, 1))
        return out

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        _require(executor, dataloader, 'AdaRound')
        self.history = []
        blocks = BlockBuilder(graph).build(self.block_size)
        if not blocks:
            return
        with _unbaked_parameters(graph):
            self._tune_blockwise(graph, blocks, dataloader, collate_fn,
                                 executor, self._tune_block)

    def _soft_round_setup(self, targets, device):
        """Per target weight: floor(w/s), s, the code range and the rounding
        variable v with h(v) = frac(w/s). Suspends the weights' runtime
        quantization (the soft-rounded weight is on the grid already);
        returns (weight info by variable name, the states to restore)."""
        saved_states = []
        winfo = {}
        for op, idx in targets:
            cfg = op.config.input_quantization_config[idx]
            saved_states.append((cfg, cfg.state))
            cfg.state = QuantizationStates.FP32
            w_var = op.inputs[idx]
            w0 = np.asarray(w_var.value, np.float32)
            scale = np.asarray(cfg.scale, np.float32)
            if cfg.policy.per_channel and cfg.channel_axis is not None:
                shape = [1] * w0.ndim
                shape[cfg.channel_axis] = -1
                s_b = scale.reshape(shape)
            else:
                s_b = scale
            floor = np.floor(w0 / s_b)
            frac = w0 / s_b - floor
            winfo[w_var.name] = {
                'floor': torch.as_tensor(floor, device=device),
                's': torch.as_tensor(np.asarray(s_b), device=device),
                'qmin': float(cfg.quant_min), 'qmax': float(cfg.quant_max),
                'v': torch.tensor(self._init_v(frac), device=device,
                                  requires_grad=True),
            }
        return winfo, saved_states

    def _soft_weights(self, params0, winfo):
        out = dict(params0)
        for name, wi in winfo.items():
            q = torch.clamp(wi['floor'] + self._h(wi['v']),
                            wi['qmin'], wi['qmax'])
            out[name] = q * wi['s']
        return out

    def _objective(self, runtime, params0, winfo, qt, fp, beta):
        """Block MSE with soft-rounded weights plus the regularizer that
        pushes every h(v) to 0 or 1."""
        loss = runtime.loss(
            runtime.run(self._soft_weights(params0, winfo), qt,
                        with_gradient=True), fp)
        reg = 0.0
        for wi in winfo.values():
            h = self._h(wi['v'])
            reg = reg + torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
        return loss + self.reg_gamma * 1e-3 * reg

    def _tune_block(self, graph, executor, block, qt_cache, fp_cache):
        targets = self._weight_targets(block)
        if not targets:
            return
        winfo, saved_states = self._soft_round_setup(targets, executor.device)
        try:
            with BlockRuntime(executor, block) as runtime:
                params0 = runtime.parameters()
                opt = torch.optim.Adam([wi['v'] for wi in winfo.values()],
                                       lr=self.lr, betas=(0.9, 0.999),
                                       eps=1e-8)
                n_cache = len(qt_cache)
                b_hi, b_lo = self.beta_anneal
                for it in range(self.steps):
                    beta = b_hi + (b_lo - b_hi) * (it / max(self.steps - 1, 1))
                    qt, fp = qt_cache[it % n_cache], fp_cache[it % n_cache]
                    opt.zero_grad(set_to_none=True)
                    total = self._objective(runtime, params0, winfo, qt, fp,
                                            beta)
                    with simulation_precision():    # no TF32 in the backward
                        total.backward()
                    opt.step()

            # finalize: hard rounding decision written into the weight
            for op, idx in targets:
                w_var = op.inputs[idx]
                wi = winfo[w_var.name]
                h = self._h(wi['v'].detach()).cpu().numpy()
                q = np.clip(wi['floor'].cpu().numpy() + (h > 0.5),
                            wi['qmin'], wi['qmax'])
                w_var.value = (q * wi['s'].cpu().numpy()).astype(np.float32)
                if w_var.name in op._fp32_params:
                    op._fp32_params[w_var.name] = np.array(w_var.value,
                                                           copy=True)
        finally:
            for cfg, state in saved_states:
                cfg.state = state


class RoundTuningPass(AdaroundPass):
    """AdaRound-lite (reference optim/training.py:866): fewer steps, rounding
    variables only."""

    def __init__(self, steps: int = 200, lr: float = 1e-3, **kwargs):
        super().__init__(steps=steps, lr=lr, **kwargs)
        self.name = 'Round Tuning Pass'
