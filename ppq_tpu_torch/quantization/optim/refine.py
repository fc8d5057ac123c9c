"""Refinement passes: simplify / fusion / alignment
(redesign of ppq/quantization/optim/refine.py).

These passes never touch values — they edit the TQC *sharing structure* so
that the simulated graph matches what a fused inference backend (or the XLA
fusion pass on TPU) will actually execute: one quantization per physical
tensor, shared grids where the hardware shares buffers.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

import numpy as np

from ...core import (LINEAR_ACTIVATIONS, TYPES_FOR_ALIGNMENT,
                     QuantizationStates, TargetPlatform, ppq_warning)
from ...ir import BaseGraph, Operation, QuantableOperation, SearchableGraph
from .base import QuantizationOptimizationPass


class QuantizeSimplifyPass(QuantizationOptimizationPass):
    """Remove duplicated quantization: when a variable's producer quantizes
    its output, consumers need not re-quantize the same tensor — their input
    TQCs become OVERLAPPED slaves of the producer's output TQC
    (reference refine.py:17-88)."""

    def __init__(self):
        super().__init__('Quantize Simplify Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for var in list(graph.variables.values()):
            if var.is_parameter:
                continue
            src = var.source_op
            if not isinstance(src, QuantableOperation):
                continue
            try:
                out_cfg = src.config_with_variable(var)
            except KeyError:
                continue
            if out_cfg.state == QuantizationStates.FP32:
                continue
            for dest in var.dest_ops:
                if not isinstance(dest, QuantableOperation):
                    continue
                in_cfg = dest.config_with_variable(var)
                if in_cfg.state != QuantizationStates.INITIAL:
                    continue
                if in_cfg.policy != out_cfg.policy or \
                        in_cfg.num_of_bits != out_cfg.num_of_bits:
                    continue
                in_cfg.dominated_by = out_cfg


class QuantizeFusionPass(QuantizationOptimizationPass):
    """Computing-op + activation fusion (reference refine.py:91-306).

    On fused backends (and on TPU, where XLA fuses the activation into the
    matmul/conv epilogue) there is no intermediate buffer between Conv and
    its activation — so no quantization may happen there. The conv's output
    TQC is overlapped by the activation's output TQC.

    Also handles `fuse_passive_op`: direct-link ops (Reshape/Transpose/...)
    whose input and output are physically the same buffer.
    """

    def __init__(self, activation_type: Optional[Set[str]] = None,
                 fuse_activation: bool = True, fuse_passive_op: bool = True):
        super().__init__('Quantize Fusion Pass')
        self.activation_types = activation_type if activation_type is not None \
            else set(LINEAR_ACTIVATIONS)
        self.fuse_activation = fuse_activation
        self.fuse_passive_op = fuse_passive_op

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        if self.fuse_activation:
            for op in list(graph.operations.values()):
                if not isinstance(op, QuantableOperation):
                    continue
                if not op.is_computing_op:
                    continue
                if len(op.outputs) != 1:
                    continue
                out_var = op.outputs[0]
                if len(out_var.dest_ops) != 1 or out_var.name in graph.outputs:
                    continue
                act = out_var.dest_ops[0]
                if act.type not in self.activation_types:
                    continue
                if not isinstance(act, QuantableOperation):
                    continue
                conv_out_cfg = op.config.output_quantization_config[0]
                act_in_cfg = act.config.input_quantization_config[0]
                act_out_cfg = act.config.output_quantization_config[0]
                conv_out_cfg.dominated_by = act_out_cfg
                act_in_cfg.dominated_by = act_out_cfg

        if self.fuse_passive_op:
            # ops whose input/output alias the same buffer: quantizing both
            # sides is redundant — overlap input by upstream's output config.
            for op in list(graph.operations.values()):
                if not isinstance(op, QuantableOperation):
                    continue
                if op.type not in {'Reshape', 'Flatten', 'Squeeze',
                                   'Unsqueeze', 'Transpose', 'Identity',
                                   'Slice', 'Split', 'MaxPool',
                                   'GlobalMaxPool', 'Pad'}:
                    continue
                in_var = op.inputs[0]
                src = in_var.source_op
                if not isinstance(src, QuantableOperation):
                    continue
                src_cfg = src.config_with_variable(in_var)
                in_cfg = op.config.input_quantization_config[0]
                if in_cfg.state in {QuantizationStates.INITIAL,
                                    QuantizationStates.ACTIVATED} and \
                        src_cfg.state != QuantizationStates.FP32:
                    in_cfg.dominated_by = src_cfg


class QuantAlignmentPass(QuantizationOptimizationPass):
    """Align scales across multi-input ops (reference refine.py:309-553).

    Add/Sub/Concat inputs land in one hardware buffer / one fused XLA op —
    their grids must match. Methods: 'Align to Large' (per-input master =
    widest-range input) or 'Align to Output' (all inputs slave to the output
    config).
    """

    def __init__(self, elementwise_alignment: str = 'Align to Large',
                 concat_alignment: str = 'Align to Output',
                 pooling_alignment: Optional[str] = None,
                 averagepool_alignment: str = 'Align to Output',
                 force_overlap: bool = False):
        super().__init__('Quantize Alignment Pass')
        self.elementwise_alignment = elementwise_alignment
        self.concat_alignment = concat_alignment
        self.pooling_alignment = pooling_alignment
        self.force_overlap = force_overlap

    def _align_to_large(self, op: QuantableOperation):
        cfgs = [c for v, c in zip(op.inputs, op.config.input_quantization_config)
                if not v.is_parameter]
        ready = [c for c in cfgs if c.has_scale]
        if len(ready) < 2:
            return
        ranges = [float(np.max(np.asarray(c.scale))) for c in ready]
        master = ready[int(np.argmax(ranges))]
        for c in ready:
            if c is master:
                continue
            c.master_by = master

    def _align_to_output(self, op: QuantableOperation):
        out_cfg = op.config.output_quantization_config[0]
        for var, c in zip(op.inputs, op.config.input_quantization_config):
            if var.is_parameter or c is out_cfg:
                continue
            if c.state == QuantizationStates.FP32:
                continue
            if self.force_overlap:
                c.dominated_by = out_cfg
            else:
                c.master_by = out_cfg

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            method = None
            if op.type in TYPES_FOR_ALIGNMENT['Elementwise']:
                method = self.elementwise_alignment
            elif op.type in TYPES_FOR_ALIGNMENT['Concat']:
                method = self.concat_alignment
            elif op.type in TYPES_FOR_ALIGNMENT['Pooling']:
                method = self.pooling_alignment
            if method is None or method == 'None':
                continue
            if method == 'Align to Large':
                self._align_to_large(op)
            elif method == 'Align to Output':
                self._align_to_output(op)
            else:
                ppq_warning(f'Unknown alignment method {method!r} on {op.name}')


class SwishFusionPass(QuantizationOptimizationPass):
    """Fuse x*Sigmoid(x) into one un-split quant region
    (reference refine.py:554)."""

    def __init__(self):
        super().__init__('Swish Fusion Pass')

    PATTERN = ('Sigmoid', 'Mul')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in list(graph.operations.values()):
            if op.type != 'Mul' or not isinstance(op, QuantableOperation):
                continue
            srcs = [v.source_op for v in op.inputs if v.source_op is not None]
            if len(srcs) != 2:
                continue
            sig = next((s for s in srcs if s.type == self._act_type()), None)
            base = next((s for s in srcs if s is not sig), None)
            if sig is None or base is None:
                continue
            if not isinstance(sig, QuantableOperation):
                continue
            # x feeds both Mul and Sigmoid
            if sig.inputs and base.outputs and \
                    sig.inputs[0].source_op is base:
                mul_out = op.config.output_quantization_config[0]
                for c in op.config.input_quantization_config:
                    c.dominated_by = mul_out
                sig.config.input_quantization_config[0].dominated_by = mul_out
                sig.config.output_quantization_config[0].dominated_by = mul_out

    def _act_type(self):
        return 'Sigmoid'


class MishFusionPass(SwishFusionPass):
    """Fuse x*Tanh(Softplus(x)) (reference refine.py:591). The pattern-match
    piggybacks on Swish with Tanh as the gate; Softplus sits between."""

    def __init__(self):
        super().__init__()
        self.name = 'Mish Fusion Pass'

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in list(graph.operations.values()):
            if op.type != 'Mul' or not isinstance(op, QuantableOperation):
                continue
            srcs = [v.source_op for v in op.inputs if v.source_op is not None]
            if len(srcs) != 2:
                continue
            tanh = next((s for s in srcs if s.type == 'Tanh'), None)
            base = next((s for s in srcs if s is not tanh), None)
            if tanh is None or base is None or not isinstance(tanh, QuantableOperation):
                continue
            sp = tanh.inputs[0].source_op if tanh.inputs else None
            if sp is None or sp.type != 'Softplus':
                continue
            if sp.inputs and sp.inputs[0].source_op is base:
                mul_out = op.config.output_quantization_config[0]
                for c in op.config.input_quantization_config:
                    c.dominated_by = mul_out
                tanh.config.input_quantization_config[0].dominated_by = mul_out
                tanh.config.output_quantization_config[0].dominated_by = mul_out
                if isinstance(sp, QuantableOperation):
                    sp.config.input_quantization_config[0].dominated_by = mul_out
                    sp.config.output_quantization_config[0].dominated_by = mul_out
