"""TorchExecutor — the quantization-simulating interpreter.

Port of ppq_tpu/executor/executor.py (TPUExecutor) to PyTorch, itself a
redesign of ppq/executor/torch.py:76-682:

  * topological walk; per op: fake-quant inputs via TQCs → forward fn →
    fake-quant outputs → hooks → store value; dead activations freed by
    consumer refcount (reference frees at torch.py:565-575).
  * runtime values live in a private dict, NOT on Variable.value —
    parameters stay pristine on the IR and the executor is reentrant.
  * the executor runs on one device, the card unless the caller names
    another. Float parameters are uploaded to it once and cached by the
    identity of the host array: a pass that rewrites `Variable.value`
    (ParameterBakingPass, DEQUANTIZE_GRAPH) assigns a new array, and the
    next forward uploads that one. A parameter at a shape-or-index input
    (a Resize's scales, a Reshape's shape; ir/opdef.py) stays on the host,
    where the op reads it, as the compiled executor keeps it.
  * `quantize_function` supports per-TQC delegates (LSQ pass plugs in
    trainable scales, reference torch.py:296,610).
  * `tracing_operation_meta` fills Variable.shape/dtype by running once.
  * `partial_graph_forward` runs a contiguous op span (blockwise finetune).
  * `forward_with_gradient` records the autograd graph through the compiled
    trainable forward (executor/compile.py), and
    `partial_graph_forward(with_gradient=True)` through this walk:
    fake-quant sites are differentiable (quantization/qfunction.py), and
    `parameters` replaces named parameters by the caller's tensors, so that
    a caller can train leaf tensors of its own while the IR keeps its
    values.

Eager per-op execution keeps data-dependent (SOI) ops trivially correct —
they run host-side numpy. The whole-graph path, the same walk captured once
per input shape into a CUDA graph, is executor/compile.py (`compile_graph`);
compiled calibration runs on it (quantization/optim/fcalibration.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import DataType, TensorQuantizationConfig
from ..ir import (BaseGraph, Operation, QuantableOperation, Variable,
                  soi_input_indices)
from ..quantization.qfunction import ppq_fake_quant
from .base import (BaseGraphExecutor, QuantRuntimeHook, RuntimeHook,
                   resolve_forward)
from .ops.default import ExecContext, simulation_precision


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Without a card and without a named device this raises; it never
    falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'ppq_tpu_torch runs on a CUDA card by default and none is '
            'available; pass device="cpu" to run on the CPU')
    return torch.device('cuda', torch.cuda.current_device())


class QuantizeDelegator:
    """Delegate interface (reference: torch.py:43 TorchQuantizeDelegator)."""

    def __call__(self, tensor, config: TensorQuantizationConfig):
        raise NotImplementedError


class TorchExecutor(BaseGraphExecutor):
    def __init__(self, graph: BaseGraph, device=None):
        self._device = resolve_device(device)
        super().__init__(graph)
        self._delegates: Dict[TensorQuantizationConfig, QuantizeDelegator] = {}
        self._ctx = ExecContext(graph, self._executing_order, self._device)
        # variable name -> (host array it was made from, device value)
        self._params: Dict[str, Any] = {}

    @property
    def device(self) -> torch.device:
        """The device this executor runs on."""
        return self._device

    # -------------------------------------------------------------- delegates
    def register_quantize_delegate(self, config: TensorQuantizationConfig,
                                   delegator: QuantizeDelegator):
        self._delegates[config] = delegator

    def remove_quantize_delegate(self, config: TensorQuantizationConfig):
        self._delegates.pop(config, None)

    def quantize_function(self, tensor, config: Optional[TensorQuantizationConfig]):
        if config is None:
            return tensor
        if config in self._delegates:
            return self._delegates[config](tensor, config)
        # host SOI values and integer tensors must stay untouched
        if not isinstance(tensor, torch.Tensor) or not tensor.is_floating_point():
            return tensor
        if not config.is_active:
            return tensor
        return ppq_fake_quant(tensor.contiguous(), config)

    def _parameter(self, var: Variable, overrides=None):
        """The device value of a parameter: the caller's override, else the
        IR's value, uploaded once per host array. The cache goes by the
        identity of the host array, so a pass that assigns a new array to
        `Variable.value` is seen by the next forward."""
        if overrides is not None and var.name in overrides:
            return overrides[var.name]
        value = var.value
        cached = self._params.get(var.name)
        if cached is not None and cached[0] is value:
            return cached[1]
        if isinstance(value, np.ndarray) and np.issubdtype(value.dtype, np.floating):
            on_device = torch.as_tensor(value, device=self._device)
        else:
            on_device = value
        self._params[var.name] = (value, on_device)
        return on_device

    def _to_device(self, value):
        if isinstance(value, torch.Tensor):
            return value.to(self._device)
        if isinstance(value, np.ndarray):
            if not value.flags.writeable:    # e.g. a view of a JAX array
                value = value.copy()
            return torch.as_tensor(value, device=self._device)
        return value

    # ---------------------------------------------------------------- forward
    def forward(self, inputs, output_names: Optional[List[str]] = None,
                hooks: Optional[Dict[str, RuntimeHook]] = None) -> List:
        """One simulated inference (reference torch.py:365)."""
        with torch.no_grad(), simulation_precision():
            return self.__forward(inputs, output_names, hooks)

    def __call__(self, inputs, output_names=None):
        return self.forward(inputs, output_names)

    def _feed(self, inputs) -> Dict[str, Any]:
        values: Dict[str, Any] = {}
        graph_inputs = list(self.graph.inputs.values())
        if isinstance(inputs, dict):
            for name, v in inputs.items():
                values[name] = self._to_device(v)
        elif isinstance(inputs, (list, tuple)):
            if len(inputs) != len(graph_inputs):
                raise ValueError(
                    f'Graph expects {len(graph_inputs)} inputs '
                    f'({[v.name for v in graph_inputs]}), got {len(inputs)}')
            for var, v in zip(graph_inputs, inputs):
                values[var.name] = self._to_device(v)
        else:
            if len(graph_inputs) != 1:
                raise ValueError(
                    f'Graph expects {len(graph_inputs)} inputs, got a single '
                    f'tensor; pass a list or dict')
            values[graph_inputs[0].name] = self._to_device(inputs)
        return values

    def forward_with_gradient(self, inputs,
                              output_names: Optional[List[str]] = None,
                              parameters: Optional[Dict[str, torch.Tensor]] = None,
                              qparams: Optional[dict] = None) -> List:
        """Differentiable forward (reference torch.py:412) through the
        compiled trainable forward (executor/compile.py
        `build_trainable_forward`), as the JAX package's is. The outputs
        carry the autograd graph back to `parameters` ({parameter name:
        tensor}, used in place of the IR's values), to `qparams` (the
        layout of `CompiledGraph.init_qparams`; the TQCs' own values if
        None) and to inputs that require a gradient. Registered delegates
        are not consulted. A graph with data-dependent ops raises, as
        CompiledGraph does."""
        from .compile import CompiledGraph
        cg = CompiledGraph(self.graph, output_names=output_names,
                           device=self._device)
        params = cg.init_params()
        params.update(parameters or {})
        if qparams is None:
            qparams = cg.init_qparams()
        return cg.build_trainable_forward()(params, qparams,
                                            self._feed(inputs))

    def __forward(self, inputs, output_names=None,
                  hooks: Optional[Dict[str, RuntimeHook]] = None,
                  op_list: Optional[Sequence[Operation]] = None,
                  parameters: Optional[Dict[str, torch.Tensor]] = None) -> List:
        values = self._feed(inputs)
        graph = self.graph
        if output_names is None:
            output_names = list(graph.outputs.keys())
        ops = list(op_list) if op_list is not None else self._executing_order

        # remaining-consumer refcount for memory reclamation
        refcount: Dict[str, int] = {}
        for op in ops:
            for var in op.inputs:
                refcount[var.name] = refcount.get(var.name, 0) + 1
        needed = set(output_names)

        # find last op index producing any requested output
        last_idx = len(ops)
        produced_by = {}
        for i, op in enumerate(ops):
            for var in op.outputs:
                produced_by[var.name] = i
        if all(name in produced_by or name in values or
               name in graph.variables and graph.variables[name].is_parameter
               for name in output_names):
            idxs = [produced_by[n] for n in output_names if n in produced_by]
            last_idx = (max(idxs) + 1) if idxs else 0

        for op in ops[:last_idx]:
            hook = hooks.get(op.name) if hooks else None
            in_vals = []
            soi = soi_input_indices(op)
            for idx, var in enumerate(op.inputs):
                if var.name in values:
                    in_vals.append(values[var.name])
                elif var.is_parameter:
                    in_vals.append(var.value if idx in soi
                                   else self._parameter(var, parameters))
                else:
                    raise RuntimeError(
                        f'Executing {op.name}: input variable {var.name} has '
                        f'no value (missing feed or broken topo order)')

            q_in_vals = in_vals
            if isinstance(op, QuantableOperation):
                q_in_vals = [self.quantize_function(v, c) for v, c in
                             zip(in_vals, op.config.input_quantization_config)]

            if hook is not None:
                if isinstance(hook, QuantRuntimeHook) and isinstance(op, QuantableOperation):
                    q_in_vals = hook.pre_forward_hook(
                        in_vals, quant_inputs=q_in_vals,
                        quant_configs=op.config.input_quantization_config)
                else:
                    q_in_vals = hook.pre_forward_hook(q_in_vals)

            fn = resolve_forward(op.platform, op.type)
            outputs = fn(op, q_in_vals, self._ctx)
            if not isinstance(outputs, (tuple, list)):
                outputs = [outputs]

            q_outputs = list(outputs)
            if isinstance(op, QuantableOperation):
                q_outputs = [self.quantize_function(v, c) for v, c in
                             zip(outputs, op.config.output_quantization_config)]

            if hook is not None:
                if isinstance(hook, QuantRuntimeHook) and isinstance(op, QuantableOperation):
                    q_outputs = hook.post_forward_hook(
                        list(outputs), quant_outputs=q_outputs,
                        quant_configs=op.config.output_quantization_config)
                else:
                    q_outputs = hook.post_forward_hook(q_outputs)

            for var, v in zip(op.outputs, q_outputs):
                values[var.name] = v

            # free dead activations
            for var in op.inputs:
                if var.is_parameter:
                    continue
                refcount[var.name] -= 1
                if (refcount[var.name] <= 0 and var.name not in needed
                        and var.name in values):
                    del values[var.name]

        results = []
        for name in output_names:
            if name in values:
                results.append(values[name])
            elif name in graph.variables and graph.variables[name].is_parameter:
                results.append(self._parameter(graph.variables[name],
                                               parameters))
            else:
                raise RuntimeError(f'Requested output {name!r} was not produced')
        return results

    # ----------------------------------------------------------------- extras
    def partial_graph_forward(self, operations: Sequence[Operation],
                              feed_dict: Dict[str, Any],
                              output_names: List[str],
                              with_gradient: bool = False,
                              parameters: Optional[Dict[str, torch.Tensor]] = None
                              ) -> List:
        """Run a sub-block only (reference torch.py:654); with_gradient
        records the autograd graph, as forward_with_gradient does."""
        with torch.set_grad_enabled(with_gradient), simulation_precision():
            return self.__forward(feed_dict, output_names, hooks=None,
                                  op_list=operations, parameters=parameters)

    def tracing_operation_meta(self, inputs,
                               output_names: Optional[List[str]] = None):
        """Shape/dtype inference by execution (reference torch.py:579-613):
        runs the graph once on the executor's device and writes observed
        meta onto Variables."""
        with torch.no_grad(), simulation_precision():
            return self._tracing_operation_meta(inputs, output_names)

    def _tracing_operation_meta(self, inputs,
                                output_names: Optional[List[str]] = None):
        values = self._feed(inputs)
        graph = self.graph
        for op in self._executing_order:
            in_vals = []
            soi = soi_input_indices(op)
            for idx, var in enumerate(op.inputs):
                if var.name in values:
                    in_vals.append(values[var.name])
                elif var.is_parameter:
                    in_vals.append(var.value if idx in soi
                                   else self._parameter(var))
                else:
                    raise RuntimeError(f'tracing: no value for {var.name}')
            # record input meta
            for var, v in zip(op.inputs, in_vals):
                if v is not None and hasattr(v, 'shape'):
                    var.shape = list(v.shape)
                    var.dtype = _dtype_of(v)
            fn = resolve_forward(op.platform, op.type)
            outputs = fn(op, in_vals, self._ctx)
            if not isinstance(outputs, (tuple, list)):
                outputs = [outputs]
            for var, v in zip(op.outputs, outputs):
                values[var.name] = v
                if v is not None and hasattr(v, 'shape'):
                    var.shape = list(v.shape)
                    var.dtype = _dtype_of(v)

    def dummy_forward(self):
        """Zero-input forward for parameter-only calibration
        (reference torch.py:615)."""
        feed = {}
        for var in self.graph.inputs.values():
            shape = [d if d and d > 0 else 1 for d in (var.shape or [1])]
            feed[var.name] = np.zeros(shape, var.dtype.to_numpy())
        return self.forward(feed)


def _dtype_of(v) -> DataType:
    dtype = v.dtype
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace('torch.', '')
    try:
        return DataType.from_numpy(np.dtype(dtype))
    except TypeError:
        return DataType.FP32
