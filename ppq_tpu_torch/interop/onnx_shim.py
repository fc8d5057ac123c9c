"""Minimal `onnx` module shim over ppq_tpu_torch's vendored protobuf
descriptors (a copy of ppq_tpu/interop/onnx_shim.py, pointed at the port's
schema `ppq_tpu_torch_onnx.proto`: recorded difference 33; the wire format
is the same, so both shims read and write the same bytes).

Without an `onnx` package the reference PPQ implementation fails to
import only because of it (`import onnx` at ppq/parser/nxp_exporter.py:1
et al.). The shim implements the small slice of the onnx API the reference
touches (load/save, ModelProto and friends, helper.make_* and
get_attribute_value, numpy_helper.to_array/from_array,
mapping.TENSOR_TYPE_TO_NP_TYPE) on top of the protoc-generated descriptors
the port's own ONNX frontend uses (frontends/onnx/onnx_pb2.py), so both
frameworks read the same bytes: enough to run reference PPQ head-to-head
on CPU torch.

Usage:
    from ppq_tpu_torch.interop import install_onnx_shim
    install_onnx_shim()          # registers sys.modules['onnx'] + submods
    sys.path.insert(0, os.environ['PPQ_REFERENCE_ROOT'])
    import ppq                   # the reference framework
"""

from __future__ import annotations

import sys
import types

import numpy as np

from ..frontends.onnx import onnx_pb2 as _pb

# --------------------------------------------------------------- dtypes ---
# TensorProto.DataType value ↔ numpy dtype (the slice with numpy analogues)
_TENSOR_TYPE_TO_NP = {
    1: np.dtype('float32'), 2: np.dtype('uint8'), 3: np.dtype('int8'),
    4: np.dtype('uint16'), 5: np.dtype('int16'), 6: np.dtype('int32'),
    7: np.dtype('int64'), 8: np.dtype('object'), 9: np.dtype('bool'),
    10: np.dtype('float16'), 11: np.dtype('float64'),
    12: np.dtype('uint32'), 13: np.dtype('uint64'),
    14: np.dtype('complex64'), 15: np.dtype('complex128'),
}
_NP_TO_TENSOR_TYPE = {v: k for k, v in _TENSOR_TYPE_TO_NP.items()
                      if v != np.dtype('object')}

# TensorProto repeated field that carries each dtype's values
_FIELD_OF = {
    1: 'float_data', 2: 'int32_data', 3: 'int32_data', 4: 'int32_data',
    5: 'int32_data', 6: 'int32_data', 7: 'int64_data', 9: 'int32_data',
    10: 'int32_data', 11: 'double_data', 12: 'uint64_data',
    13: 'uint64_data',
}


# --------------------------------------------------------- numpy_helper ---
def to_array(tensor) -> np.ndarray:
    dt = _TENSOR_TYPE_TO_NP.get(int(tensor.data_type), np.dtype('float32'))
    dims = list(tensor.dims)
    if tensor.raw_data:
        if int(tensor.data_type) == 16:           # bfloat16 → f32
            raw = np.frombuffer(tensor.raw_data, np.uint16).astype(np.uint32)
            return (raw << 16).view(np.float32).reshape(dims).copy()
        return np.frombuffer(tensor.raw_data, dt).reshape(dims).copy()
    field = _FIELD_OF.get(int(tensor.data_type), 'float_data')
    vals = np.asarray(list(getattr(tensor, field)))
    if int(tensor.data_type) == 10:               # float16 packed as uint16
        vals = vals.astype(np.uint16).view(np.float16)
    return vals.astype(dt).reshape(dims)


def from_array(arr: np.ndarray, name: str = ''):
    arr = np.asarray(arr)
    t = _pb.TensorProto()
    t.name = name
    t.dims.extend(arr.shape)
    dt = _NP_TO_TENSOR_TYPE.get(arr.dtype)
    if dt is None:
        arr = arr.astype(np.float32)
        dt = 1
    t.data_type = dt
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


# --------------------------------------------------------------- helper ---
def get_attribute_value(attr):
    A = _pb.AttributeProto.AttributeType
    at = int(attr.type)
    if at == A.FLOAT:
        return float(attr.f)
    if at == A.INT:
        return int(attr.i)
    if at == A.STRING:
        return attr.s.decode('utf-8', errors='replace')
    if at == A.TENSOR:
        return attr.t
    if at == A.GRAPH:
        return attr.g
    if at == A.FLOATS:
        return [float(v) for v in attr.floats]
    if at == A.INTS:
        return [int(v) for v in attr.ints]
    if at == A.STRINGS:
        return [s.decode('utf-8', errors='replace') for s in attr.strings]
    if at == A.TENSORS:
        return list(attr.tensors)
    if at == A.GRAPHS:
        return list(attr.graphs)
    raise ValueError(f'unsupported attribute type {at}')


def make_attribute(key, value):
    a = _pb.AttributeProto()
    a.name = key
    A = _pb.AttributeProto.AttributeType
    if isinstance(value, float):
        a.f, a.type = value, A.FLOAT
    elif isinstance(value, (bool, int, np.integer)):
        a.i, a.type = int(value), A.INT
    elif isinstance(value, str):
        a.s, a.type = value.encode(), A.STRING
    elif isinstance(value, bytes):
        a.s, a.type = value, A.STRING
    elif isinstance(value, _pb.TensorProto):
        a.t.CopyFrom(value)
        a.type = A.TENSOR
    elif isinstance(value, np.ndarray):
        a.t.CopyFrom(from_array(value))
        a.type = A.TENSOR
    elif isinstance(value, (list, tuple, np.ndarray)) or hasattr(value, '__iter__'):
        vals = list(value)
        if all(isinstance(v, (int, np.integer)) for v in vals):
            a.ints.extend(int(v) for v in vals)
            a.type = A.INTS
        elif all(isinstance(v, (int, float, np.floating, np.integer))
                 for v in vals):
            a.floats.extend(float(v) for v in vals)
            a.type = A.FLOATS
        elif all(isinstance(v, str) for v in vals):
            a.strings.extend(v.encode() for v in vals)
            a.type = A.STRINGS
        else:
            raise ValueError(f'unsupported attribute list {key}={value!r}')
    else:
        raise ValueError(f'unsupported attribute {key}={value!r}')
    return a


def make_node(op_type, inputs, outputs, name=None, doc_string=None,
              domain=None, **kwargs):
    n = _pb.NodeProto()
    n.op_type = op_type
    n.input.extend(inputs)
    n.output.extend(outputs)
    if name is not None:
        n.name = name
    if domain is not None:
        n.domain = domain
    for k, v in sorted(kwargs.items()):
        if v is None:
            continue
        n.attribute.append(make_attribute(k, v))
    return n


def make_tensor(name, data_type, dims, vals, raw=False):
    t = _pb.TensorProto()
    t.name = name
    t.data_type = int(data_type)
    t.dims.extend(dims)
    if raw:
        t.raw_data = vals if isinstance(vals, bytes) else bytes(vals)
    else:
        dt = _TENSOR_TYPE_TO_NP.get(int(data_type), np.dtype('float32'))
        arr = np.asarray(vals, dt).reshape(list(dims) if dims else [-1])
        t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


def make_tensor_value_info(name, elem_type, shape, doc_string='',
                           shape_denotation=None):
    vi = _pb.ValueInfoProto()
    vi.name = name
    tt = vi.type.tensor_type
    tt.elem_type = int(elem_type)
    if shape is not None:
        for d in shape:
            dim = tt.shape.dim.add()
            if d is None:
                dim.dim_param = '?'
            elif isinstance(d, str):
                dim.dim_param = d
            else:
                dim.dim_value = int(d)
    return vi


def make_graph(nodes, name, inputs, outputs, initializer=None,
               doc_string=None, value_info=None):
    g = _pb.GraphProto()
    g.name = name
    g.node.extend(nodes)
    g.input.extend(inputs)
    g.output.extend(outputs)
    if initializer:
        g.initializer.extend(initializer)
    if value_info:
        g.value_info.extend(value_info)
    return g


def make_model(graph, **kwargs):
    m = _pb.ModelProto()
    m.ir_version = 8
    m.graph.CopyFrom(graph)
    opsets = kwargs.pop('opset_imports', None)
    if opsets:
        m.opset_import.extend(opsets)
    else:
        op = m.opset_import.add()
        op.domain, op.version = '', 13
    for k, v in kwargs.items():
        try:
            setattr(m, k, v)
        except Exception:
            pass
    return m


def make_opsetid(domain, version):
    op = _pb.OperatorSetIdProto()
    op.domain, op.version = domain, version
    return op


def printable_graph(graph) -> str:
    lines = [f'graph {graph.name} ({len(graph.node)} nodes)']
    for n in graph.node:
        lines.append(f'  {n.op_type} {list(n.input)} -> {list(n.output)}')
    return '\n'.join(lines)


# ------------------------------------------------------------- load/save ---
def load(path, format=None, load_external_data=True):
    m = _pb.ModelProto()
    data = path.read() if hasattr(path, 'read') else open(path, 'rb').read()
    m.ParseFromString(data)
    return m


def load_model_from_string(data):
    m = _pb.ModelProto()
    m.ParseFromString(data)
    return m


def save(model, path, format=None):
    data = model.SerializeToString()
    if hasattr(path, 'write'):
        path.write(data)
    else:
        with open(path, 'wb') as f:
            f.write(data)


save_model = save


def _check_model(model, full_check=False):
    # structural no-op: the shim performs no schema validation
    return None


# ---------------------------------------------------------------- install --
def install_onnx_shim(force: bool = False) -> types.ModuleType:
    """Register the shim as `onnx` (+ helper/numpy_helper/mapping/checker
    submodules) in sys.modules. No-op when a real onnx is importable,
    unless force=True."""
    if 'onnx' in sys.modules and not force:
        return sys.modules['onnx']

    onnx = types.ModuleType('onnx')
    onnx.__version__ = '1.13.0+ppq_tpu_torch_shim'
    # torch._dynamo.trace_rules probes importlib.util.find_spec('onnx'),
    # which raises on a registered module whose __spec__ is None — give
    # the shim a synthetic spec so the probe sees an ordinary module
    import importlib.machinery
    onnx.__spec__ = importlib.machinery.ModuleSpec('onnx', loader=None)
    # proto classes (the same descriptors as the port's own frontend)
    for cls in ('ModelProto', 'GraphProto', 'NodeProto', 'TensorProto',
                'AttributeProto', 'ValueInfoProto', 'TypeProto',
                'TensorShapeProto', 'OperatorSetIdProto',
                'StringStringEntryProto'):
        setattr(onnx, cls, getattr(_pb, cls))
    onnx.OperatorProto = _pb.OperatorSetIdProto      # placeholder alias
    onnx.load = load
    onnx.load_model = load
    onnx.load_model_from_string = load_model_from_string
    onnx.save = save
    onnx.save_model = save

    helper = types.ModuleType('onnx.helper')
    for fn in (get_attribute_value, make_attribute, make_node, make_tensor,
               make_tensor_value_info, make_graph, make_model, make_opsetid,
               printable_graph):
        setattr(helper, fn.__name__, fn)

    numpy_helper = types.ModuleType('onnx.numpy_helper')
    numpy_helper.to_array = to_array
    numpy_helper.from_array = from_array

    mapping = types.ModuleType('onnx.mapping')
    mapping.TENSOR_TYPE_TO_NP_TYPE = dict(_TENSOR_TYPE_TO_NP)
    mapping.NP_TYPE_TO_TENSOR_TYPE = dict(_NP_TO_TENSOR_TYPE)

    checker = types.ModuleType('onnx.checker')
    checker.check_model = _check_model

    onnx.helper = helper
    onnx.numpy_helper = numpy_helper
    onnx.mapping = mapping
    onnx.checker = checker
    sys.modules['onnx'] = onnx
    sys.modules['onnx.helper'] = helper
    sys.modules['onnx.numpy_helper'] = numpy_helper
    sys.modules['onnx.mapping'] = mapping
    sys.modules['onnx.checker'] = checker
    return onnx
