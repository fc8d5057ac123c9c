"""Quantable wrappers over the IR (redesign of ppq/IR/quantize.py:15-324).

A QuantableOperation is an Operation that additionally carries an
OperationQuantizationConfig (one TQC per input/output) plus fp32 shadow
copies of its parameters, so any pass can temporarily *dequantize* the op
(run a float reference forward) and then restore quantization — the
mechanism behind error analysis, bias correction and blockwise finetuning.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import (OperationQuantizationConfig, QuantizationStates,
                    TensorQuantizationConfig)
from .graph import BaseGraph, Operation, Variable


class QuantableOperation(Operation):
    """Operation + quantization configs (ppq/IR/quantize.py:15)."""

    def __init__(self, name: str, op_type: str,
                 config: OperationQuantizationConfig, **kwargs):
        super().__init__(name, op_type, **kwargs)
        self.config = config
        self._fp32_params: Dict[str, np.ndarray] = {}
        self._dequant_stack: List[List[QuantizationStates]] = []

    @classmethod
    def from_operation(cls, op: Operation,
                       config: OperationQuantizationConfig) -> 'QuantableOperation':
        q = cls(op.name, op.type, config,
                attributes=op.attributes, platform=op.platform, opset=op.opset)
        q.inputs = op.inputs
        q.outputs = op.outputs
        q.detail = op.detail
        return q

    # ------------------------------------------------------------ accessors
    @property
    def input_quant_config(self) -> List[TensorQuantizationConfig]:
        return self.config.input_quantization_config

    @property
    def output_quant_config(self) -> List[TensorQuantizationConfig]:
        return self.config.output_quantization_config

    def config_with_variable(self, var: Variable) -> TensorQuantizationConfig:
        """TQC governing the given connected variable
        (ppq/IR/quantize.py:162)."""
        for v, c in zip(self.inputs, self.config.input_quantization_config):
            if v is var or v.name == var.name:
                return c
        for v, c in zip(self.outputs, self.config.output_quantization_config):
            if v is var or v.name == var.name:
                return c
        raise KeyError(f'Variable {var.name} is not connected to {self.name}')

    def config_pairs(self) -> List[Tuple[Variable, TensorQuantizationConfig]]:
        return (list(zip(self.inputs, self.config.input_quantization_config)) +
                list(zip(self.outputs, self.config.output_quantization_config)))

    # --------------------------------------------------------- fp32 shadows
    def store_parameter_value(self):
        """Snapshot current fp32 parameter values
        (ppq/IR/quantize.py:113)."""
        for var in self.inputs:
            if var.is_parameter and var.has_value:
                self._fp32_params[var.name] = np.array(var.value, copy=True)

    def baking_parameters(self, quant_fn) -> 'QuantableOperation':
        """Statically quantize parameters in place; runtime then applies no
        quant math on them (ppq/IR/quantize.py:98-111).

        quant_fn(value: np.ndarray, cfg: TQC) -> np.ndarray (fake-quantized).
        """
        for var, cfg in zip(self.inputs, self.config.input_quantization_config):
            if not var.is_parameter or not var.has_value:
                continue
            if cfg.state == QuantizationStates.ACTIVATED:
                if var.name not in self._fp32_params:
                    self._fp32_params[var.name] = np.array(var.value, copy=True)
                var.value = np.asarray(quant_fn(var.value, cfg))
                cfg.state = QuantizationStates.BAKED
            elif cfg.state == QuantizationStates.PASSIVE:
                if var.name not in self._fp32_params:
                    self._fp32_params[var.name] = np.array(var.value, copy=True)
                var.value = np.asarray(quant_fn(var.value, cfg))
                cfg.state = QuantizationStates.PASSIVE_BAKED
        return self

    def dequantize(self, parameter_only: bool = False):
        """Temporarily disable quantization (ppq/IR/quantize.py:124):
        restore fp32 parameter values and push current TQC states, setting
        them to FP32. Reversible via restore_quantize_state()."""
        saved = [c.state for c in self.config]
        self._dequant_stack.append(saved)
        for var, cfg in zip(self.inputs, self.config.input_quantization_config):
            if var.is_parameter and var.name in self._fp32_params:
                var.value = np.array(self._fp32_params[var.name], copy=True)
            if parameter_only and not var.is_parameter:
                continue
            cfg.state = QuantizationStates.FP32
        for cfg in self.config.output_quantization_config:
            if not parameter_only:
                cfg.state = QuantizationStates.FP32

    def restore_quantize_state(self, quant_fn=None):
        """Undo the innermost dequantize() (ppq/IR/quantize.py:143). Ops whose
        params were BAKED are re-baked when quant_fn is given, otherwise
        their configs drop back to ACTIVATED."""
        if not self._dequant_stack:
            return
        saved = self._dequant_stack.pop()
        for cfg, state in zip(self.config, saved):
            cfg.state = state
        if quant_fn is not None:
            for var, cfg in zip(self.inputs, self.config.input_quantization_config):
                if var.is_parameter and cfg.state in {
                        QuantizationStates.BAKED, QuantizationStates.PASSIVE_BAKED}:
                    var.value = np.asarray(quant_fn(self._fp32_params[var.name], cfg))
        else:
            for var, cfg in zip(self.inputs, self.config.input_quantization_config):
                if var.is_parameter and cfg.state in {
                        QuantizationStates.BAKED, QuantizationStates.PASSIVE_BAKED}:
                    # cannot re-bake without quant_fn; fall back to runtime quant
                    var.value = np.array(self._fp32_params[var.name], copy=True)
                    cfg.state = (QuantizationStates.ACTIVATED
                                 if cfg.state == QuantizationStates.BAKED
                                 else QuantizationStates.PASSIVE)

    def __repr__(self):
        return (f'QuantableOperation({self.name!r}, type={self.type}, '
                f'platform={self.platform.name})')


def quantize_operation(graph: BaseGraph, op_name: str,
                       config: OperationQuantizationConfig) -> QuantableOperation:
    """Swap an Operation for its Quantable wrapper in place
    (ppq/IR/quantize.py:259-324 QuantableGraph)."""
    op = graph.operations[op_name]
    if isinstance(op, QuantableOperation):
        return op
    qop = QuantableOperation.from_operation(op, config)
    # rewire variable links to point at the new object
    for var in qop.inputs:
        var.dest_ops[:] = [qop if d is op else d for d in var.dest_ops]
    for var in qop.outputs:
        if var.source_op is op:
            var.source_op = qop
    graph.operations[op_name] = qop
    qop.store_parameter_value()
    return qop


def dequantize_graph(graph: BaseGraph):
    for op in graph.operations.values():
        if isinstance(op, QuantableOperation):
            op.dequantize()


def restore_graph_quantization(graph: BaseGraph, quant_fn=None):
    for op in graph.operations.values():
        if isinstance(op, QuantableOperation):
            op.restore_quantize_state(quant_fn)
