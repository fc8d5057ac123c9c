"""QDQ ONNX exporter (port of ppq_tpu/frontends/onnxruntime.py; redesign
of ppq/parser/onnxruntime_exporter.py:41-511).

Writes a deployment-ready ONNX model in the QDQ dialect: every exportable
activation TQC becomes a QuantizeLinear→DequantizeLinear pair; weights are
stored as real int8 initializers followed by DequantizeLinear (per-channel
via the axis attribute, opset 13). Used for ONNXRuntime, TensorRT (QDQ
flavor), OpenVINO and Metax deployment.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np

from ..core import (DataType, QuantizationStates, TensorQuantizationConfig,
                    ppq_warning)
from ..ir import BaseGraph, GraphExporter, Operation, QuantableOperation, Variable
from ..quantization.qfunction import ppq_quant_toint
from .onnx import graph_to_model_proto
from .onnx.exporter import dump_quant_config_json


class QDQHelper:
    """Q/DQ insertion surgery over a copied BaseGraph."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph
        self._n = 0

    def _mkname(self, prefix: str) -> str:
        self._n += 1
        return f'{prefix}_{self._n}_ppq'

    def _zp_dtype(self, cfg: TensorQuantizationConfig):
        if cfg.quant_min < 0:
            return np.int8, DataType.INT8
        return np.uint8, DataType.UINT8

    def _qparam_vars(self, cfg: TensorQuantizationConfig
                     ) -> Tuple[Variable, Variable]:
        scale = np.asarray(cfg.scale, np.float32)
        if cfg.policy.floating:
            # floating QDQ dialect: float32 offset (reference
            # onnxruntime_exporter.py:116)
            offset = np.asarray(cfg.offset, np.float32)
        else:
            np_dt, _ = self._zp_dtype(cfg)
            offset = np.asarray(np.round(cfg.offset), np.int64).astype(np_dt)
        if not cfg.policy.per_channel:
            scale = scale.reshape(())
            offset = offset.reshape(())
        s_var = self.graph.create_variable(
            self._mkname('scale'), value=scale, is_parameter=True)
        z_var = self.graph.create_variable(
            self._mkname('zero_point'), value=offset, is_parameter=True)
        return s_var, z_var

    def _axis_attr(self, cfg: TensorQuantizationConfig) -> dict:
        if cfg.policy.per_channel and cfg.channel_axis is not None:
            return {'axis': int(cfg.channel_axis)}
        return {}

    def insert_qdq_on_activation(self, var: Variable,
                                 cfg: TensorQuantizationConfig):
        """var -> QuantizeLinear -> DequantizeLinear -> (old consumers)."""
        g = self.graph
        s_var, z_var = self._qparam_vars(cfg)
        attrs = self._axis_attr(cfg)

        q_out = g.create_variable(self._mkname(f'{var.name}_q'))
        dq_out = g.create_variable(self._mkname(f'{var.name}_dq'))

        q_type, dq_type = 'QuantizeLinear', 'DequantizeLinear'
        if cfg.policy.floating:
            # FP8 configs export the reference's floating QDQ dialect
            # (onnxruntime_exporter.py:113 QuantizeFloating): custom ops
            # carrying min/max/exponent/mantissa
            q_type, dq_type = 'QuantizeFloating', 'DequantizeFloating'
            attrs = dict(attrs, min=float(cfg.quant_min),
                         max=float(cfg.quant_max),
                         exponent=int(cfg.exponent_bits),
                         mantissa=int(cfg.num_of_bits - 1
                                      - cfg.exponent_bits))

        old_dests = [d for d in var.dest_ops]
        q_op = g.create_operation(q_type,
                                  name=self._mkname(f'{var.name}_{q_type}'),
                                  attributes=dict(attrs),
                                  inputs=[var, s_var, z_var], outputs=[q_out])
        dq_op = g.create_operation(dq_type,
                                   name=self._mkname(f'{var.name}_{dq_type}'),
                                   attributes=dict(attrs),
                                   inputs=[q_out, s_var, z_var],
                                   outputs=[dq_out])
        # rewire old consumers to read dq_out
        for dest in old_dests:
            for i, v in enumerate(dest.inputs):
                if v is var:
                    dest.inputs[i] = dq_out
            dq_out.dest_ops.append(dest)
        var.dest_ops[:] = [d for d in var.dest_ops if d not in old_dests]
        # graph outputs re-point through the DQ
        if var.name in g.outputs:
            del g.outputs[var.name]
            g.mark_as_output(dq_out)

    def insert_qdq_on_edge(self, var: Variable,
                           cfg: TensorQuantizationConfig, dest):
        """var -> Q -> DQ -> (ONLY `dest`); other consumers keep reading
        `var` directly. Used for joint-quant slave inputs (state PASSIVE):
        the simulator re-quantizes the value on THIS edge with the master's
        scale, so the deployed graph must too — a variable-level QDQ would
        wrongly requantize every consumer."""
        g = self.graph
        s_var, z_var = self._qparam_vars(cfg)
        attrs = self._axis_attr(cfg)
        q_out = g.create_variable(self._mkname(f'{var.name}_eq'))
        dq_out = g.create_variable(self._mkname(f'{var.name}_edq'))
        g.create_operation('QuantizeLinear',
                           name=self._mkname(f'{var.name}_edge_Q'),
                           attributes=dict(attrs),
                           inputs=[var, s_var, z_var], outputs=[q_out])
        g.create_operation('DequantizeLinear',
                           name=self._mkname(f'{var.name}_edge_DQ'),
                           attributes=dict(attrs),
                           inputs=[q_out, s_var, z_var], outputs=[dq_out])
        replaced = False
        for i, v in enumerate(dest.inputs):
            if v is var:
                dest.inputs[i] = dq_out
                replaced = True
        if replaced:
            dq_out.dest_ops.append(dest)
            if dest in var.dest_ops:
                var.dest_ops.remove(dest)

    def insert_dq_on_parameter(self, var: Variable,
                               cfg: TensorQuantizationConfig):
        """Replace fp32 weight with int initializer + DequantizeLinear.
        Floating (FP8) configs keep the fp32 initializer and wrap it in a
        QuantizeFloating -> DequantizeFloating pair instead (the ONNX
        standard has no fp8 initializer the target opset guarantees; the
        reference exports the same floating QDQ dialect)."""
        g = self.graph
        if cfg.policy.floating:
            self.insert_qdq_on_activation(var, cfg)
            return
        int_value = ppq_quant_toint(np.asarray(var.value), cfg)
        np_dt, ir_dt = self._zp_dtype(cfg)
        if cfg.num_of_bits == 8:
            int_value = int_value.astype(np_dt)
            var.dtype = ir_dt
        else:
            int_value = int_value.astype(np.int32)
            var.dtype = DataType.INT32
        var.value = int_value

        s_var, z_var = self._qparam_vars(cfg)
        attrs = self._axis_attr(cfg)
        dq_out = g.create_variable(self._mkname(f'{var.name}_dq'))
        old_dests = [d for d in var.dest_ops]
        dq_op = g.create_operation('DequantizeLinear',
                                   name=self._mkname(f'{var.name}_DequantizeLinear'),
                                   attributes=dict(attrs),
                                   inputs=[var, s_var, z_var],
                                   outputs=[dq_out])
        for dest in old_dests:
            for i, v in enumerate(dest.inputs):
                if v is var:
                    dest.inputs[i] = dq_out
            dq_out.dest_ops.append(dest)
        var.dest_ops[:] = [d for d in var.dest_ops if d not in old_dests]


def remove_fused_activations(g: BaseGraph) -> Dict[str, 'TensorQuantizationConfig']:
    """Drop Relu/Clip ops whose clamp is already expressed by an ASYMMETRIC
    quant range (reference onnxruntime_exporter.py:213 remove_activation_ops)
    — in the QDQ dialect the Q/DQ pair clips to [qmin, qmax], so exporting
    the activation op would double-clamp and break backend conv-act fusion.

    Returns {surviving_var_name: activation_output_cfg} so the caller plans
    the Q/DQ insertion with the activation's calibrated range."""
    forced: Dict[str, TensorQuantizationConfig] = {}
    removable = []
    for op in g.topological_sort():
        if not isinstance(op, QuantableOperation):
            continue
        if op.type not in ('Relu', 'Clip'):
            continue
        cfg = op.config.output_quantization_config[0].dominated_by
        if cfg.policy.symmetric or not cfg.has_scale:
            continue
        scale = np.asarray(cfg.scale, np.float32)
        offset = np.asarray(cfg.offset, np.float32)
        range_min = float((scale * (cfg.quant_min - offset)).min())
        range_max = float((scale * (cfg.quant_max - offset)).max())
        ok = False
        if op.type == 'Relu':
            ok = range_min >= 0.0
        else:                                   # Clip
            lo, hi = -np.inf, np.inf
            if len(op.inputs) >= 2 and op.inputs[1].has_value:
                lo = float(np.asarray(op.inputs[1].value).reshape(-1)[0])
            if len(op.inputs) >= 3 and op.inputs[2].has_value:
                hi = float(np.asarray(op.inputs[2].value).reshape(-1)[0])
            ok = range_min >= lo and range_max <= hi
        ups = g.get_upstream_operations(op)
        if not ok or len(ups) != 1:
            continue
        if len(g.get_downstream_operations(ups[0])) != 1:
            continue
        removable.append((op, cfg))
    for op, cfg in removable:
        in_var = next(v for v in op.inputs if not v.is_parameter)
        g.remove_operation(op, keep_coherence=True)
        forced[in_var.name] = cfg
    return forced


def dedup_qdq(g: BaseGraph):
    """Collapse Quant→Dequant→Quant→Dequant chains with matching qparams to
    a single pair (reference onnxruntime_exporter.py:307)."""
    for op in list(g.operations.values()):
        if op.name not in g.operations or op.type != 'QuantizeLinear':
            continue
        src = op.inputs[0].source_op
        if src is None or src.type != 'DequantizeLinear':
            continue
        s1, z1 = src.inputs[1].value, src.inputs[2].value
        s2, z2 = op.inputs[1].value, op.inputs[2].value
        if s1 is None or s2 is None or np.shape(s1) != np.shape(s2):
            continue
        if float(np.max(np.abs(np.asarray(s1) - np.asarray(s2)))) > 1e-5:
            continue
        if float(np.max(np.abs(np.asarray(z1, np.float32) -
                               np.asarray(z2, np.float32)))) > 0.5:
            continue
        downs = g.get_downstream_operations(op)
        if len(downs) != 1 or downs[0].type != 'DequantizeLinear':
            continue
        dq2 = downs[0]
        g.remove_operation(op, keep_coherence=True)
        g.remove_operation(dq2, keep_coherence=True)


def convert_to_opset13(g: BaseGraph):
    """Move attribute-style axes/split to inputs as opset 13 requires
    (reference onnxruntime_exporter.py:366)."""
    from ..ir.morph import format_axes_to_input
    format_axes_to_input(g)
    for op in g.operations.values():
        if op.type == 'ReduceSum' and 'axes' in op.attributes:
            axes = np.asarray(op.attributes.pop('axes'), np.int64)
            g.create_variable(value=axes, is_parameter=True, dest_ops=[op])


class ONNXRuntimeExporter(GraphExporter):
    """(reference: parser/onnxruntime_exporter.py ONNXRUNTIMExporter)

    Export pipeline: copy graph → remove fused activations → opset-13
    normalization → plan one Q/DQ site per variable → insert → dedup
    back-to-back Q/DQ pairs → serialize."""

    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        g = graph.copy(copy_value=True)
        helper = QDQHelper(g)
        forced = remove_fused_activations(g)
        convert_to_opset13(g)

        # choose one exportable cfg per variable (producer output preferred,
        # reference dedupe logic onnxruntime_exporter.py:307)
        done: Set[str] = set()
        plan_act: Dict[str, TensorQuantizationConfig] = {}
        plan_w: Dict[str, TensorQuantizationConfig] = {}
        # joint-quant slave inputs (state PASSIVE, non-parameter): the sim
        # re-quantizes the value on that specific EDGE with the master's
        # scale; export a per-edge QDQ pair unless the variable already
        # carries the same grid — (dest_op, input_idx, var_name, cfg)
        plan_edge = []

        for op in list(g.operations.values()):
            if not isinstance(op, QuantableOperation):
                continue
            in_vars = set(id(v) for v in op.inputs)
            for var, cfg in op.config_pairs():
                is_input = id(var) in in_vars
                root = cfg.dominated_by
                state = cfg.state
                if is_input and not var.is_parameter and \
                        state == QuantizationStates.PASSIVE:
                    if cfg.can_export and root.has_scale and \
                            not cfg.policy.floating:
                        for i, v in enumerate(op.inputs):
                            if v is var:
                                plan_edge.append((op, i, var.name, cfg))
                    continue
                if var.name in done:
                    continue
                if var.name in forced and not var.is_parameter:
                    # the removed activation's calibrated range wins
                    plan_act[var.name] = forced[var.name]
                    done.add(var.name)
                    continue
                if state == QuantizationStates.OVERLAPPED:
                    continue
                if not cfg.can_export or not root.has_scale:
                    continue
                if state == QuantizationStates.FP32:
                    continue
                if var.is_parameter:
                    if state in {QuantizationStates.ACTIVATED,
                                 QuantizationStates.BAKED,
                                 QuantizationStates.PASSIVE,
                                 QuantizationStates.PASSIVE_BAKED}:
                        if state in {QuantizationStates.BAKED,
                                     QuantizationStates.PASSIVE_BAKED}:
                            # restore fp32 before re-quantizing to ints
                            if var.name in op._fp32_params:
                                var.value = op._fp32_params[var.name]
                        plan_w[var.name] = cfg
                        done.add(var.name)
                else:
                    plan_act[var.name] = cfg
                    done.add(var.name)

        for name, cfg in plan_w.items():
            helper.insert_dq_on_parameter(g.variables[name], cfg)
        for name, cfg in plan_act.items():
            helper.insert_qdq_on_activation(g.variables[name], cfg)
        for dest, idx, name, cfg in plan_edge:
            base = plan_act.get(name, forced.get(name))
            if base is not None:
                try:
                    r1, r2 = base.dominated_by, cfg.dominated_by
                    same = (np.array_equal(np.asarray(r1.scale),
                                           np.asarray(r2.scale)) and
                            np.array_equal(np.asarray(r1.offset),
                                           np.asarray(r2.offset)))
                except Exception:
                    same = False    # can't prove — insert (idempotent if equal)
                if same:
                    continue        # same grid — the variable QDQ covers it
            helper.insert_qdq_on_edge(dest.inputs[idx], cfg, dest)
        dedup_qdq(g)

        model = graph_to_model_proto(g, opset_version=13)
        with open(file_path, 'wb') as f:
            f.write(model.SerializeToString())
        if config_path:
            dump_quant_config_json(graph, config_path)
