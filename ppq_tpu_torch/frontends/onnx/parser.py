"""ONNX → BaseGraph parser (port of ppq_tpu/frontends/onnx/parser.py;
redesign of ppq/parser/onnx_parser.py:9-176).

Self-contained: uses the in-repo compiled protobuf schema (onnx_pb2), no
dependency on the `onnx` package. Initializers become parameter Variables,
graph inputs that are not initializers become graph inputs, node attributes
are decoded to python/numpy values.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ...core import DataType, ppq_warning
from ...ir import BaseGraph, GraphBuilder, Operation, Opset, Variable
from . import onnx_pb2 as pb


def decode_tensor_proto(t: 'pb.TensorProto') -> np.ndarray:
    dims = tuple(t.dims)
    dtype = DataType(t.data_type) if t.data_type else DataType.FP32
    np_dtype = dtype.to_numpy()
    if t.raw_data:
        # a copy: a view of the message's bytes would be read-only
        arr = np.frombuffer(t.raw_data, dtype=np_dtype).copy()
    elif t.float_data:
        arr = np.asarray(t.float_data, np.float32).astype(np_dtype)
    elif t.int64_data:
        arr = np.asarray(t.int64_data, np.int64).astype(np_dtype)
    elif t.int32_data:
        # int32_data carries int32/int16/int8/uint8/bool/fp16 payloads
        arr = np.asarray(t.int32_data, np.int32).astype(np_dtype)
    elif t.double_data:
        arr = np.asarray(t.double_data, np.float64).astype(np_dtype)
    elif t.uint64_data:
        arr = np.asarray(t.uint64_data, np.uint64).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return arr.reshape(dims) if dims else arr.reshape(())


def encode_tensor_proto(name: str, value: np.ndarray) -> 'pb.TensorProto':
    t = pb.TensorProto()
    t.name = name
    value = np.ascontiguousarray(value)
    t.data_type = int(DataType.from_numpy(value.dtype))
    t.dims.extend(value.shape)
    t.raw_data = value.tobytes()
    return t


def decode_attribute(attr: 'pb.AttributeProto') -> Any:
    A = pb.AttributeProto
    if attr.type == A.FLOAT:
        return float(attr.f)
    if attr.type == A.INT:
        return int(attr.i)
    if attr.type == A.STRING:
        return attr.s.decode('utf-8', errors='replace')
    if attr.type == A.TENSOR:
        return decode_tensor_proto(attr.t)
    if attr.type == A.FLOATS:
        return [float(v) for v in attr.floats]
    if attr.type == A.INTS:
        return [int(v) for v in attr.ints]
    if attr.type == A.STRINGS:
        return [s.decode('utf-8', errors='replace') for s in attr.strings]
    if attr.type == A.GRAPH:
        return attr.g           # kept raw; If/Loop subgraphs parsed on demand
    if attr.type == A.GRAPHS:
        return list(attr.graphs)
    ppq_warning(f'Attribute {attr.name} has unsupported type {attr.type}; ignored')
    return None


def encode_attribute(name: str, value: Any) -> 'pb.AttributeProto':
    A = pb.AttributeProto
    attr = pb.AttributeProto(name=name)
    if isinstance(value, bool):
        attr.type, attr.i = A.INT, int(value)
    elif isinstance(value, (int, np.integer)):
        attr.type, attr.i = A.INT, int(value)
    elif isinstance(value, (float, np.floating)):
        attr.type, attr.f = A.FLOAT, float(value)
    elif isinstance(value, str):
        attr.type, attr.s = A.STRING, value.encode()
    elif isinstance(value, np.ndarray):
        attr.type = A.TENSOR
        attr.t.CopyFrom(encode_tensor_proto(name, value))
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            attr.type = A.INTS
            attr.ints.extend(int(v) for v in value)
        elif all(isinstance(v, (int, float, np.floating, np.integer)) for v in value):
            attr.type = A.FLOATS
            attr.floats.extend(float(v) for v in value)
        elif all(isinstance(v, str) for v in value):
            attr.type = A.STRINGS
            attr.strings.extend(v.encode() for v in value)
        else:
            raise TypeError(f'Cannot encode attribute {name}={value!r}')
    elif isinstance(value, pb.GraphProto):
        attr.type = A.GRAPH
        attr.g.CopyFrom(value)
    else:
        raise TypeError(f'Cannot encode attribute {name}={value!r} '
                        f'({type(value).__name__})')
    return attr


class OnnxParser(GraphBuilder):
    """Builds a BaseGraph from an onnx file / bytes / ModelProto."""

    def build(self, model) -> BaseGraph:
        if isinstance(model, (str, bytes)):
            proto = pb.ModelProto()
            if isinstance(model, str):
                with open(model, 'rb') as f:
                    proto.ParseFromString(f.read())
            else:
                proto.ParseFromString(model)
        else:
            proto = model
        g = proto.graph
        opset = Opset()
        for imp in proto.opset_import:
            if imp.domain in ('', 'ai.onnx'):
                opset = Opset(imp.domain, imp.version)
        graph = BaseGraph(g.name or 'onnx_graph')
        graph._detail['ir_version'] = proto.ir_version
        graph._detail['opset'] = opset

        # --- initializers → parameter variables
        for init in g.initializer:
            graph.append_variable(Variable(
                init.name, value=decode_tensor_proto(init), is_parameter=True))

        # --- declared value infos (shapes/dtypes)
        shape_info: Dict[str, tuple] = {}
        for vi in list(g.input) + list(g.output) + list(g.value_info):
            if vi.type.HasField('tensor_type'):
                tt = vi.type.tensor_type
                dims = []
                for d in tt.shape.dim:
                    dims.append(d.dim_value if d.HasField('dim_value') else -1)
                shape_info[vi.name] = (dims, DataType(tt.elem_type)
                                       if tt.elem_type else DataType.FP32)

        def get_var(name: str) -> Variable:
            if name not in graph.variables:
                shape, dtype = shape_info.get(name, (None, DataType.FP32))
                graph.append_variable(Variable(name, shape=shape, dtype=dtype))
            return graph.variables[name]

        # --- nodes
        n_unnamed = 0
        for node in g.node:
            name = node.name
            if not name:
                n_unnamed += 1
                name = f'{node.op_type}_{n_unnamed}'
            while name in graph.operations:
                n_unnamed += 1
                name = f'{name}_{n_unnamed}'
            attributes = {a.name: decode_attribute(a) for a in node.attribute}
            op = Operation(name, node.op_type, attributes=attributes, opset=opset)
            graph.operations[name] = op
            for in_name in node.input:
                if in_name == '':
                    # optional input left empty — positional placeholder
                    ph = graph.create_variable(is_parameter=True)
                    ph.dest_ops.append(op)
                    op.inputs.append(ph)
                    continue
                var = get_var(in_name)
                op.inputs.append(var)
                var.dest_ops.append(op)
            for out_name in node.output:
                if out_name == '':
                    ph = graph.create_variable()
                    ph.source_op = op
                    op.outputs.append(ph)
                    continue
                var = get_var(out_name)
                op.outputs.append(var)
                var.source_op = var.source_op or op

        # --- graph inputs / outputs
        initializer_names = {i.name for i in g.initializer}
        for vi in g.input:
            if vi.name in initializer_names:
                continue
            graph.mark_as_input(get_var(vi.name))
        for vi in g.output:
            graph.mark_as_output(get_var(vi.name))

        # apply known shapes to variables
        for name, (dims, dtype) in shape_info.items():
            if name in graph.variables and not graph.variables[name].is_parameter:
                var = graph.variables[name]
                if var.shape is None:
                    var.shape = dims
                var.dtype = dtype
        return graph


def load_onnx_graph(path_or_bytes) -> BaseGraph:
    """Convenience entry (reference: ppq/api/interface.py:39)."""
    return OnnxParser().build(path_or_bytes)
