"""BaseGraph → ONNX exporter (port of ppq_tpu/frontends/onnx/exporter.py;
redesign of ppq/parser/onnx_exporter.py:86).

Plain fp32 export: writes the graph as-is (quant-aware QDQ export lives in
frontends/onnxruntime.py on top of this). Optionally emits a
quantization-config JSON sidecar (reference: onnx_exporter.py:96). `producer_name` is
`PPQ_TPU_CONFIG.NAME`, the port's own name.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ...core import (DataType, PPQ_TPU_CONFIG, QuantizationStates)
from ...ir import BaseGraph, GraphExporter, QuantableOperation
from . import onnx_pb2 as pb
from .parser import encode_attribute, encode_tensor_proto


def graph_to_model_proto(graph: BaseGraph,
                         opset_version: Optional[int] = None) -> 'pb.ModelProto':
    model = pb.ModelProto()
    model.ir_version = graph._detail.get('ir_version', 8)
    model.producer_name = PPQ_TPU_CONFIG.NAME
    model.producer_version = PPQ_TPU_CONFIG.VERSION
    opset = model.opset_import.add()
    opset.domain = ''
    stored = graph._detail.get('opset')
    opset.version = opset_version or (stored.version if stored else 13)

    g = model.graph
    g.name = graph.name

    for op in graph.topological_sort():
        node = g.node.add()
        node.name = op.name
        node.op_type = op.type
        node.input.extend(v.name for v in op.inputs)
        node.output.extend(v.name for v in op.outputs)
        for key, value in op.attributes.items():
            if value is None:
                continue
            node.attribute.append(encode_attribute(key, value))

    for var in graph.variables.values():
        if var.is_parameter and var.has_value:
            g.initializer.append(encode_tensor_proto(var.name, np.asarray(var.value)))

    def add_value_info(coll, var):
        vi = coll.add()
        vi.name = var.name
        tt = vi.type.tensor_type
        tt.elem_type = int(var.dtype)
        if var.shape is not None:
            for d in var.shape:
                dim = tt.shape.dim.add()
                if d is not None and int(d) >= 0:
                    dim.dim_value = int(d)
                else:
                    dim.dim_param = 'dyn'

    for var in graph.inputs.values():
        add_value_info(g.input, var)
    for var in graph.outputs.values():
        add_value_info(g.output, var)
    return model


def dump_quant_config_json(graph: BaseGraph, config_path: str):
    """Quantization parameter sidecar (reference: onnx_exporter.py:96)."""
    records = {}
    for op in graph.operations.values():
        if not isinstance(op, QuantableOperation):
            continue
        entry = {}
        for var, cfg in op.config_pairs():
            if not cfg.can_export or not cfg.has_scale:
                continue
            entry[var.name] = cfg.to_dict()
        if entry:
            records[op.name] = entry
    with open(config_path, 'w') as f:
        json.dump(records, f, indent=2)


class OnnxExporter(GraphExporter):
    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        model = graph_to_model_proto(graph, kwargs.get('opset_version'))
        with open(file_path, 'wb') as f:
            f.write(model.SerializeToString())
        if config_path:
            dump_quant_config_json(graph, config_path)
