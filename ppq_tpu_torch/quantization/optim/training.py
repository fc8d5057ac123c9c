"""Training-based optimization passes: bias correction, LSQ, AdaRound
(port of ppq_tpu/quantization/optim/training.py, itself a redesign of
ppq/quantization/optim/training.py + legacy.py).

All finetuning is blockwise (BlockBuilder). A block is compiled as an op
span (`CompiledGraph(graph, op_span=block.rps, ...)`) and trained through
its `build_trainable_forward()`, as the JAX package does: the fake-quant
sites are `torch.autograd.Function`s over the hand-written forward and
backward kernels (quantization/qfunction.py), weights and the roots' scales
and offsets are leaf tensors of the pass's own, and the optimizer is
`torch.optim.Adam`. The JAX package jits the whole step (forward, loss,
gradient, Adam); here the step is a `_CapturedStep`: on the card the
block's first step runs as it is and every later one is one replay of a
CUDA graph that holds forward, loss, backward and Adam. The IR keeps its
values until a block's result is accepted.

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

from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core import COMPUTING_OP, QuantizationStates, ppq_info
from ...executor.compile import CompiledGraph
from ...executor.ops.default import simulation_precision
from ...ir import (BaseGraph, QuantableOperation, dequantize_graph,
                   restore_graph_quantization)
from ...kernels.loader import LAUNCHES
from ..algorithm.blocks import BlockBuilder, TrainableBlock
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


def _shape_key(feed: Dict[str, torch.Tensor]):
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(feed.items()))


class _CapturedStep:
    """One block's step, the counterpart of the JAX package's jitted step:
    `body(feed)` on a dict of tensors (a whole optimisation step, or one
    evaluation of the block), returning None or a list of tensors.

    On the card, the first call for each set of input shapes runs the body
    as it is, on a side stream: that is a real step (its result counts), and
    it loads the kernels, makes the optimizer's state and sizes the
    workspaces, none of which a capture may do. Then the body is captured
    into a CUDA graph on static copies of the inputs; capturing runs
    nothing. Every later call copies its inputs into the static buffers and
    replays the graph, which adds `launches_per_replay` to `LAUNCHES`. A
    replay never waits on the host. With `capture=False`, and on the CPU,
    every call runs the body as it is."""

    def __init__(self, body: Callable, device: torch.device,
                 capture: bool = True):
        self.body = body
        self.capture = bool(capture) and torch.device(device).type == 'cuda'
        self.graphs: Dict[tuple, tuple] = {}
        self.launches_per_replay: Dict[str, int] = {}
        self.replays = 0

    def __call__(self, feed: Dict[str, torch.Tensor]):
        if not self.capture:
            return self.body(feed)
        key = _shape_key(feed)
        entry = self.graphs.get(key)
        if entry is None:
            return self._first(key, feed)
        graph, static_in, static_out, launches = entry
        for k, v in feed.items():
            static_in[k].copy_(v)
        graph.replay()
        self.replays += 1
        for k, v in launches.items():
            LAUNCHES[k] += v
        return _cloned(static_out)

    def _first(self, key, feed):
        device = next(iter(feed.values())).device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.body(feed)
        main.wait_stream(side)
        for t in out or []:
            t.record_stream(main)
        static_in = {k: v.detach().clone() for k, v in feed.items()}
        graph = torch.cuda.CUDAGraph()
        before = dict(LAUNCHES)
        with torch.cuda.graph(graph):
            static_out = self.body(static_in)
        launches = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES
                    if LAUNCHES[k] != before.get(k, 0)}
        LAUNCHES.update(before)            # the capture ran nothing
        self.launches_per_replay = launches
        self.graphs[key] = (graph, static_in, static_out, launches)
        return out


def _cloned(out):
    return None if out is None else [t.clone() for t in out]


def _mse(outs, targets: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """Sum over the named outputs of the mean squared error."""
    total = 0.0
    for name, out in zip(names, outs):
        if name in targets:
            total = total + torch.mean((out - targets[name]) ** 2)
    return total


def _block_graph(graph: BaseGraph, block: TrainableBlock, device,
                 output_names: Optional[List[str]] = None):
    """The block as a compiled op span and its trainable forward. Raises,
    as CompiledGraph does, for a block with data-dependent ops."""
    cg = CompiledGraph(graph, op_span=block.rps,
                       input_names=block.input_names,
                       output_names=list(output_names or block.output_names),
                       device=device)
    return cg, cg.build_trainable_forward()


def _leaves(tree: Dict[str, torch.Tensor], trainable: bool):
    """Private copies of init_params / init_qparams tensors (on the CPU
    they may share memory with the IR's arrays), optionally trainable."""
    def leaf(v):
        return v.detach().clone().requires_grad_(trainable)
    return {k: ({kk: leaf(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in tree.items()}


def _qparam_tensors(qparams) -> List[torch.Tensor]:
    return [t for pair in qparams.values() for t in pair.values()]


class TrainingBasedPass(QuantizationOptimizationPass):
    """Shared machinery (reference optim/training.py:18)."""

    # on the card every step after a block's first is a CUDA-graph replay;
    # an instance set to False runs every step as it is (the same
    # arithmetic)
    capture = True
    # an instance set to True keeps each block's trained tensors and
    # optimizer state (on the host) in its history entry
    keep_state = False

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

    def _record(self, what: str, block, pre_loss: float, post_loss: float,
                step: Optional[_CapturedStep] = None, state=None):
        accepted = post_loss < pre_loss
        entry = dict(block=repr(block), pre_loss=pre_loss,
                     post_loss=post_loss, accepted=accepted)
        if step is not None:
            entry.update(replays=step.replays,
                         launches_per_replay=dict(step.launches_per_replay))
        if state is not None and self.keep_state:
            entry['state'] = state()
        self.history.append(entry)
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
    def block_loss(fwd, params, qparams, block: TrainableBlock,
                   qt_cache: Cache, fp_cache: Cache) -> float:
        """The block's loss over the caches through its compiled forward
        `fwd`: one read from the device."""
        total = 0.0
        with torch.no_grad():
            for qt, fp in zip(qt_cache, fp_cache):
                outs = fwd(params, qparams,
                           {n: qt[n] for n in block.input_names})
                total = total + _mse(outs, fp, block.output_names)
        return float(total) / max(len(qt_cache), 1)

    @staticmethod
    def _feed(block: TrainableBlock, qt, fp) -> Dict[str, torch.Tensor]:
        """A step's inputs: the block's cached inputs and fp32 targets."""
        feed = {'in:' + n: qt[n] for n in block.input_names}
        feed.update({'out:' + n: fp[n] for n in block.output_names})
        return feed

    @staticmethod
    def _adam(tensors, lr: float, device) -> torch.optim.Adam:
        """optax.adam's defaults; on the card the capturable form (its step
        count lives on the device), uncaptured steps included, so that a
        captured and an uncaptured run do the same arithmetic."""
        return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=torch.device(device).type == 'cuda')


def _require(executor, dataloader, what: str):
    if dataloader is None:
        raise ValueError(f'{what} requires a dataloader')
    if executor is None:
        raise ValueError(f'{what} requires an executor: it trains on the '
                         f"executor's device")


def _host_state(params, qparams, opt) -> dict:
    """Trained tensors and Adam's state, copied to the host."""
    return {
        'params': {k: v.detach().cpu() for k, v in params.items()},
        'qparams': {k: {kk: vv.detach().cpu() for kk, vv in v.items()}
                    for k, v in qparams.items()},
        'adam': {i: {k: v.detach().cpu() for k, v in st.items()}
                 for i, st in opt.state_dict()['state'].items()}
        if opt is not None else {},
    }


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

    def block_trainer(self, graph, block, device,
                      capture: Optional[bool] = None):
        """One block's trainer: its compiled forward, its initial and its
        trainable params and qparams, Adam, and `step(feed)` (a
        `_CapturedStep`; `feed` from `_feed`). None when the block has
        nothing to train. capture: the pass's own setting unless given."""
        cg, fwd = _block_graph(graph, block, device)
        params0 = cg.init_params()
        qparams0 = cg.init_qparams()
        if not params0 and not qparams0:
            return None
        params = _leaves(params0, True)
        qparams = _leaves(qparams0, self.is_scale_trainable)
        trainable = list(params.values())
        if self.is_scale_trainable:
            trainable += _qparam_tensors(qparams)
        opt = self._adam(trainable, self.lr, device) if trainable else None

        def body(feed):
            opt.zero_grad(set_to_none=True)
            outs = fwd(params, qparams,
                       {n: feed['in:' + n] for n in block.input_names})
            loss = _mse(outs, {n: feed['out:' + n]
                               for n in block.output_names},
                        block.output_names)
            with simulation_precision():    # no TF32 in the backward
                loss.backward()
            opt.step()

        return SimpleNamespace(
            cg=cg, fwd=fwd, params0=params0, qparams0=qparams0,
            params=params, qparams=qparams, opt=opt,
            step=_CapturedStep(body, device, self.capture if capture is None
                               else capture))

    def _finetune_block(self, graph, executor, block, qt_cache, fp_cache):
        t = self.block_trainer(graph, block, executor.device)
        if t is None:
            return
        pre_loss = self.block_loss(t.fwd, t.params0, t.qparams0, block,
                                   qt_cache, fp_cache)
        n_cache = len(qt_cache)
        for it in range(self.steps if t.opt is not None else 0):
            t.step(self._feed(block, qt_cache[it % n_cache],
                              fp_cache[it % n_cache]))
        post_loss = self.block_loss(t.fwd, t.params, t.qparams, block,
                                    qt_cache, fp_cache)
        # accept (reference check, training.py:115)
        if self._record('LSQ', block, pre_loss, post_loss, t.step,
                        lambda: _host_state(t.params, t.qparams, t.opt)):
            for name, value in t.params.items():
                _sync_fp32_shadow(graph, name, value.detach().cpu().numpy())
            if self.is_scale_trainable:
                t.cg.write_back_qparams(t.qparams)


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
    check/rollback, training.py:521-526). Each evaluation of the block over
    the cache is one `_CapturedStep` a batch."""

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

    def _evaluate(self, fwd, params, qparams, block, qt_cache, device):
        """The block's outputs on every cached batch."""
        def body(feed):
            with torch.no_grad():
                return fwd(params, qparams, feed)
        step = _CapturedStep(body, device, self.capture)
        return [step({n: qt[n] for n in block.input_names})
                for qt in qt_cache]

    def _correct_block(self, graph, executor, block, qt_cache, fp_cache):
        targets = [op for op in block.rps
                   if isinstance(op, QuantableOperation)
                   and op.type in ('Conv', 'ConvTranspose', 'Gemm')
                   and len(op.inputs) == 3
                   and op.inputs[-1].is_parameter]
        if not targets:
            return
        device = executor.device
        t_outs = [op.outputs[0].name for op in targets]
        names = list(dict.fromkeys(list(block.output_names) + t_outs))
        cg, fwd = _block_graph(graph, block, device, names)
        params0 = cg.init_params()
        qparams0 = cg.init_qparams()
        # the fp term: the same block, on the same inputs, dequantized
        for op in block.rps:
            if isinstance(op, QuantableOperation):
                op.dequantize(parameter_only=False)
        try:
            cg_f, fwd_f = _block_graph(graph, block, device, names)
            fp_vals = self._evaluate(fwd_f, cg_f.init_params(), {}, block,
                                     qt_cache, device)
        finally:
            for op in block.rps:
                if isinstance(op, QuantableOperation):
                    op.restore_quantize_state()
        qt_vals = self._evaluate(fwd, params0, qparams0, block, qt_cache,
                                 device)

        def loss_of(vals) -> float:
            total = sum(_mse(outs, fp, names)
                        for outs, fp in zip(vals, fp_cache))
            return float(total) / max(len(vals), 1)

        pre_loss = loss_of(qt_vals)
        corrections = {}
        for op in targets:
            idx = names.index(op.outputs[0].name)
            errs = [self._channel_mean(f[idx], op.type)
                    - self._channel_mean(q[idx], op.type)
                    for f, q in zip(fp_vals, qt_vals)]
            corrections[op.inputs[-1].name] = torch.stack(errs).mean(dim=0)

        params_new = dict(params0)
        for bname, err in corrections.items():
            if bname in params_new:
                params_new[bname] = params_new[bname] + \
                    err.to(params_new[bname].dtype)
        post_loss = loss_of(self._evaluate(fwd, params_new, qparams0, block,
                                           qt_cache, device))
        # accept (reference training.py:521)
        if self._record('BiasCorrection', block, pre_loss, post_loss,
                        state=lambda: {'corrections': {
                            k: v.cpu() for k, v in corrections.items()}}):
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

    def _objective(self, fwd, params0, qparams0, winfo, block, qt, fp, beta):
        """Block MSE with soft-rounded weights plus the regularizer that
        pushes every h(v) to 0 or 1. beta: a float32 tensor (a capture
        reads it from the device)."""
        outs = fwd(self._soft_weights(params0, winfo), qparams0,
                   {n: qt[n] for n in block.input_names})
        loss = _mse(outs, fp, block.output_names)
        reg = 0.0
        for wi in winfo.values():
            h = self._h(wi['v'])
            reg = reg + torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
        return loss + self.reg_gamma * 1e-3 * reg

    def _tune_block(self, graph, executor, block, qt_cache, fp_cache):
        targets = self._weight_targets(block)
        if not targets:
            return
        device = executor.device
        winfo, saved_states = self._soft_round_setup(targets, device)
        try:
            cg, fwd = _block_graph(graph, block, device)
            params0 = cg.init_params()
            qparams0 = cg.init_qparams()
            vs = [wi['v'] for wi in winfo.values()]
            opt = self._adam(vs, self.lr, device)

            def body(feed):
                opt.zero_grad(set_to_none=True)
                total = self._objective(
                    fwd, params0, qparams0, winfo, block,
                    {n: feed['in:' + n] for n in block.input_names},
                    {n: feed['out:' + n] for n in block.output_names},
                    feed['beta'])
                with simulation_precision():    # no TF32 in the backward
                    total.backward()
                opt.step()

            step = _CapturedStep(body, device, self.capture)
            n_cache = len(qt_cache)
            b_hi, b_lo = self.beta_anneal
            betas = torch.tensor(
                [b_hi + (b_lo - b_hi) * (it / max(self.steps - 1, 1))
                 for it in range(self.steps)], dtype=torch.float32,
                device=device)
            for it in range(self.steps):
                feed = self._feed(block, qt_cache[it % n_cache],
                                  fp_cache[it % n_cache])
                feed['beta'] = betas[it]
                step(feed)
            self.history.append(dict(
                block=repr(block), replays=step.replays,
                launches_per_replay=dict(step.launches_per_replay)))
            if self.keep_state:
                self.history[-1]['state'] = _host_state(
                    {n: wi['v'] for n, wi in winfo.items()}, {}, opt)

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
