"""Graph IR: Variable / Operation / BaseGraph.

Capability-equivalent redesign of ppq/IR/base/graph.py (Variable:15,
Operation:157, BaseGraph:229). The IR is a host-side, mutable,
networkx-free DAG: dict-of-ops + dict-of-vars with explicit edge lists.
Tensor *values* (parameters, cached activations) are numpy arrays on host —
device placement is the executor/compiler's concern, which is what makes the
whole-graph XLA compilation path possible (values become jnp constants or
donated buffers at trace time, never torch-style live device tensors inside
the IR).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import (DataType, TargetPlatform, TensorQuantizationConfig,
                    ppq_warning)


class Opset:
    """ONNX-style opset tag (ppq/IR/base/opdef.py:9)."""

    def __init__(self, domain: str = '', version: int = 13):
        self.domain = domain
        self.version = version

    def __repr__(self):
        return f'Opset({self.domain!r}, {self.version})'


class Variable:
    """A tensor edge in the graph (ppq/IR/base/graph.py:15-154)."""

    def __init__(self, name: str, value: Optional[np.ndarray] = None,
                 is_parameter: bool = False,
                 source_op: Optional['Operation'] = None,
                 dest_ops: Optional[List['Operation']] = None,
                 shape: Optional[Sequence[int]] = None,
                 dtype: DataType = DataType.FP32):
        self.name = name
        self.is_parameter = is_parameter
        self.source_op = source_op
        self.dest_ops: List['Operation'] = list(dest_ops) if dest_ops else []
        self._value = value
        self._shape = list(shape) if shape is not None else None
        self._dtype = dtype
        if value is not None:
            self._shape = list(value.shape)
            try:
                self._dtype = DataType.from_numpy(value.dtype)
            except TypeError:
                pass

    # ------------------------------------------------------------ value/meta
    @property
    def value(self) -> Optional[np.ndarray]:
        return self._value

    @value.setter
    def value(self, v):
        self._value = v
        if v is not None and hasattr(v, 'shape'):
            self._shape = list(v.shape)
            if isinstance(v, np.ndarray):
                try:
                    self._dtype = DataType.from_numpy(v.dtype)
                except TypeError:
                    pass

    @property
    def has_value(self) -> bool:
        return self._value is not None

    @property
    def shape(self) -> Optional[List[int]]:
        return self._shape

    @shape.setter
    def shape(self, s):
        self._shape = list(s) if s is not None else None

    @property
    def dtype(self) -> DataType:
        return self._dtype

    @dtype.setter
    def dtype(self, d: DataType):
        self._dtype = d

    @property
    def ndim(self) -> Optional[int]:
        return None if self._shape is None else len(self._shape)

    def dest_idx(self, op: 'Operation') -> int:
        return self.dest_ops.index(op)

    def copy(self, copy_value: bool = True) -> 'Variable':
        v = None
        if copy_value and self._value is not None:
            v = np.array(self._value, copy=True) if isinstance(self._value, np.ndarray) else self._value
        var = Variable(self.name, value=v, is_parameter=self.is_parameter,
                       shape=self._shape, dtype=self._dtype)
        return var

    def __repr__(self):
        tag = 'param' if self.is_parameter else 'act'
        return f'Variable({self.name!r}, {tag}, shape={self._shape}, {self._dtype.name})'


class Operation:
    """A node in the graph (ppq/IR/base/graph.py:157-226)."""

    def __init__(self, name: str, op_type: str,
                 attributes: Optional[Dict[str, Any]] = None,
                 platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 opset: Optional[Opset] = None,
                 inputs: Optional[List[Variable]] = None,
                 outputs: Optional[List[Variable]] = None):
        self.name = name
        self.type = op_type
        self.attributes: Dict[str, Any] = dict(attributes) if attributes else {}
        self.platform = platform
        self.opset = opset or Opset()
        self.inputs: List[Variable] = list(inputs) if inputs else []
        self.outputs: List[Variable] = list(outputs) if outputs else []
        # extension point for passes to stash per-op data
        self.detail: Dict[str, Any] = {}

    # ------------------------------------------------------------- topology
    @property
    def parameters(self) -> List[Variable]:
        return [v for v in self.inputs if v.is_parameter]

    @property
    def num_of_parameter(self) -> int:
        return len(self.parameters)

    @property
    def is_computing_op(self) -> bool:
        from ..core.common import COMPUTING_OP
        return self.type in COMPUTING_OP

    @property
    def is_soi_generator(self) -> bool:
        from ..core.common import SOI_OP
        return self.type in SOI_OP

    def input_idx(self, var: Variable) -> int:
        return self.inputs.index(var)

    def output_idx(self, var: Variable) -> int:
        return self.outputs.index(var)

    @property
    def socket(self) -> 'OpSocket':
        from .opdef import socket_of
        return socket_of(self)

    def __repr__(self):
        return (f'Operation({self.name!r}, type={self.type}, '
                f'platform={self.platform.name})')


class BaseGraph:
    """The mutable DAG (ppq/IR/base/graph.py:229-936).

    Invariants maintained by every surgery helper:
      * `operations[name].inputs[i]` is an entry of `variables`
      * `var.source_op.outputs` contains var; every `d in var.dest_ops`
        has var in `d.inputs`
      * graph inputs/outputs are tracked by name in `self.inputs/outputs`
    """

    def __init__(self, name: str = 'graph'):
        self.name = name
        self.operations: Dict[str, Operation] = {}
        self.variables: Dict[str, Variable] = {}
        self.inputs: Dict[str, Variable] = {}
        self.outputs: Dict[str, Variable] = {}
        self._detail: Dict[str, Any] = {}
        self._num_of_generated = 0

    # ------------------------------------------------------------- builders
    def append_operation(self, op: Operation):
        if op.name in self.operations:
            raise KeyError(f'Duplicate operation name {op.name!r}')
        for var in op.inputs + op.outputs:
            if var.name not in self.variables:
                self.variables[var.name] = var
        self.operations[op.name] = op
        return op

    def append_variable(self, var: Variable):
        if var.name in self.variables:
            raise KeyError(f'Duplicate variable name {var.name!r}')
        self.variables[var.name] = var
        return var

    def create_variable(self, name: Optional[str] = None,
                        value: Optional[np.ndarray] = None,
                        is_parameter: bool = False,
                        dest_ops: Optional[List[Operation]] = None,
                        source_op: Optional[Operation] = None,
                        shape: Optional[Sequence[int]] = None,
                        dtype: DataType = DataType.FP32) -> Variable:
        if name is None:
            name = self._generate_name('var')
        var = Variable(name, value=value, is_parameter=is_parameter,
                       source_op=source_op, dest_ops=dest_ops,
                       shape=shape, dtype=dtype)
        self.append_variable(var)
        if source_op is not None:
            source_op.outputs.append(var)
        if dest_ops:
            for d in dest_ops:
                d.inputs.append(var)
        return var

    def create_operation(self, op_type: str, name: Optional[str] = None,
                         attributes: Optional[Dict[str, Any]] = None,
                         platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                         inputs: Optional[List[Variable]] = None,
                         outputs: Optional[List[Variable]] = None) -> Operation:
        if name is None:
            name = self._generate_name(op_type)
        op = Operation(name, op_type, attributes=attributes, platform=platform)
        self.append_operation(op)
        if inputs:
            for var in inputs:
                self.connect(var, op)
        if outputs:
            for var in outputs:
                op.outputs.append(var)
                var.source_op = op
        return op

    def _generate_name(self, prefix: str) -> str:
        while True:
            self._num_of_generated += 1
            name = f'{prefix}_{self._num_of_generated}'
            if name not in self.operations and name not in self.variables:
                return name

    # ------------------------------------------------------------- topology
    def connect(self, var: Variable, op: Operation):
        """var → op (append to op.inputs and var.dest_ops)."""
        op.inputs.append(var)
        var.dest_ops.append(op)

    def get_downstream_operations(self, op: Operation) -> List[Operation]:
        seen, out = set(), []
        for var in op.outputs:
            for d in var.dest_ops:
                if d.name not in seen:
                    seen.add(d.name)
                    out.append(d)
        return out

    def get_upstream_operations(self, op: Operation) -> List[Operation]:
        seen, out = set(), []
        for var in op.inputs:
            if var.source_op is not None and var.source_op.name not in seen:
                seen.add(var.source_op.name)
                out.append(var.source_op)
        return out

    def topological_sort(self) -> List[Operation]:
        """Kahn's algorithm (ppq/IR/base/graph.py:333-361)."""
        # in-degree counts UNIQUE upstream producers (not edges): the
        # relaxation below decrements once per producer, and an op may
        # consume several outputs of the same producer (e.g. both halves
        # of a Split feeding one Concat)
        in_deg = {name: 0 for name in self.operations}
        for op in self.operations.values():
            in_deg[op.name] = sum(
                1 for up in self.get_upstream_operations(op)
                if up.name in self.operations)
        ready = [self.operations[n] for n, d in sorted(in_deg.items()) if d == 0]
        order: List[Operation] = []
        while ready:
            op = ready.pop(0)
            order.append(op)
            for d in self.get_downstream_operations(op):
                in_deg[d.name] -= 1
                if in_deg[d.name] == 0:
                    ready.append(d)
        if len(order) != len(self.operations):
            cyclic = sorted(set(self.operations) - {o.name for o in order})
            raise RuntimeError(
                f'Graph contains a cycle or dangling edge; unsortable ops: '
                f'{cyclic[:10]}')
        return order

    # -------------------------------------------------------------- surgery
    def remove_operation(self, op: Operation, keep_coherence: bool = False):
        """Delete op. With keep_coherence, single-in/single-out ops are
        spliced out: upstream var is rewired to downstream consumers
        (ppq/IR/base/graph.py:586-653)."""
        if op.name not in self.operations:
            raise KeyError(f'{op.name} not in graph')
        if keep_coherence:
            acts = [v for v in op.inputs if not v.is_parameter]
            if len(acts) != 1 or len(op.outputs) != 1:
                raise ValueError(
                    f'keep_coherence removal needs exactly 1 activation input '
                    f'and 1 output, {op.name} has {len(acts)}/{len(op.outputs)}')
            in_var, out_var = acts[0], op.outputs[0]
            # detach op
            for var in list(op.inputs):
                if op in var.dest_ops:
                    var.dest_ops.remove(op)
                if var.is_parameter:
                    self._drop_variable_if_isolated(var)
            # rewire consumers of out_var to in_var
            for d in list(out_var.dest_ops):
                idx = d.input_idx(out_var)
                d.inputs[idx] = in_var
                in_var.dest_ops.append(d)
            # graph output passthrough
            if out_var.name in self.outputs:
                del self.outputs[out_var.name]
                self.outputs[in_var.name] = in_var
            out_var.dest_ops.clear()
            out_var.source_op = None
            self.variables.pop(out_var.name, None)
            self.operations.pop(op.name)
            return
        # plain removal: detach all edges
        for var in list(op.inputs):
            while op in var.dest_ops:
                var.dest_ops.remove(op)
            if var.is_parameter:
                self._drop_variable_if_isolated(var)
        for var in list(op.outputs):
            var.source_op = None
            if not var.dest_ops and var.name not in self.outputs:
                self.variables.pop(var.name, None)
        self.operations.pop(op.name)

    def _drop_variable_if_isolated(self, var: Variable):
        if not var.dest_ops and var.source_op is None:
            self.variables.pop(var.name, None)
            self.inputs.pop(var.name, None)

    def remove_variable(self, var: Variable):
        if var.source_op is not None:
            while var in var.source_op.outputs:
                var.source_op.outputs.remove(var)
        for d in list(var.dest_ops):
            while var in d.inputs:
                d.inputs.remove(var)
        self.variables.pop(var.name, None)
        self.inputs.pop(var.name, None)
        self.outputs.pop(var.name, None)

    def insert_op_on_var(self, inserting_op: Operation, var: Variable):
        """Insert op after var: var → inserting_op → (new var) → old dests
        (ppq/IR/base/graph.py:363-414)."""
        if inserting_op.name not in self.operations:
            self.append_operation(inserting_op)
        link_var = self.create_variable(source_op=inserting_op)
        link_var.shape = var.shape
        link_var.dtype = var.dtype
        for d in list(var.dest_ops):
            idx = d.input_idx(var)
            d.inputs[idx] = link_var
            link_var.dest_ops.append(d)
        var.dest_ops.clear()
        self.connect(var, inserting_op)
        if var.name in self.outputs:
            del self.outputs[var.name]
            self.outputs[link_var.name] = link_var

    def insert_op_between_var_and_op(self, inserting_op: Operation,
                                     up_var: Variable, down_op: Operation):
        """Insert on one specific edge up_var→down_op
        (ppq/IR/base/graph.py:455-503)."""
        if inserting_op.name not in self.operations:
            self.append_operation(inserting_op)
        if down_op not in up_var.dest_ops:
            raise ValueError(f'{up_var.name} does not feed {down_op.name}')
        link_var = self.create_variable(source_op=inserting_op)
        link_var.shape = up_var.shape
        link_var.dtype = up_var.dtype
        idx = down_op.input_idx(up_var)
        down_op.inputs[idx] = link_var
        link_var.dest_ops.append(down_op)
        up_var.dest_ops.remove(down_op)
        self.connect(up_var, inserting_op)

    def insert_op_between_ops(self, inserting_op: Operation,
                              up_op: Operation, down_op: Operation):
        for var in up_op.outputs:
            if down_op in var.dest_ops:
                self.insert_op_between_var_and_op(inserting_op, var, down_op)
                return
        raise ValueError(f'No edge between {up_op.name} and {down_op.name}')

    # ------------------------------------------------------- inputs/outputs
    def mark_as_input(self, var: Variable):
        self.inputs[var.name] = var

    def mark_as_output(self, var: Variable):
        self.outputs[var.name] = var

    # ----------------------------------------------------------------- copy
    def copy(self, copy_value: bool = True) -> 'BaseGraph':
        """Deep copy incl. re-linking TQC dominator chains
        (ppq/IR/base/graph.py:836-921)."""
        from .quantize import QuantableOperation
        g = BaseGraph(self.name)
        g._num_of_generated = self._num_of_generated
        for name, var in self.variables.items():
            g.variables[name] = var.copy(copy_value=copy_value)
        tqc_map: Dict[TensorQuantizationConfig, TensorQuantizationConfig] = {}
        for name, op in self.operations.items():
            new_op = Operation(op.name, op.type, attributes=_copy_attr(op.attributes),
                               platform=op.platform,
                               opset=Opset(op.opset.domain, op.opset.version))
            if isinstance(op, QuantableOperation):
                qcfg = op.config.copy()
                wrapped = QuantableOperation.from_operation(new_op, qcfg)
                for old, new in zip(op.config, qcfg):
                    tqc_map[old] = new
                new_op = wrapped
            new_op.inputs = [g.variables[v.name] for v in op.inputs]
            new_op.outputs = [g.variables[v.name] for v in op.outputs]
            g.operations[name] = new_op
        # re-link topology
        for name, op in g.operations.items():
            src = self.operations[name]
            for v_old, v_new in zip(src.inputs, op.inputs):
                v_new.dest_ops.append(op)
            for v_old, v_new in zip(src.outputs, op.outputs):
                v_new.source_op = op
        # re-link dominator chains into the copied TQC universe
        for old, new in tqc_map.items():
            if old._dominator is not old:
                target = old._dominator
                if target in tqc_map:
                    new._dominator = tqc_map[target]
                # else: dominator lives outside the copied graph; keep link
        for name in self.inputs:
            g.inputs[name] = g.variables[name]
        for name in self.outputs:
            g.outputs[name] = g.variables[name]
        return g

    # ------------------------------------------------------------ utilities
    def __contains__(self, item) -> bool:
        if isinstance(item, Operation):
            return item.name in self.operations and self.operations[item.name] is item
        if isinstance(item, Variable):
            return item.name in self.variables
        return item in self.operations or item in self.variables

    def __len__(self):
        return len(self.operations)

    def parameters(self) -> Dict[str, np.ndarray]:
        return {name: v.value for name, v in self.variables.items()
                if v.is_parameter and v.has_value}

    def __repr__(self):
        return (f'BaseGraph({self.name!r}, {len(self.operations)} ops, '
                f'{len(self.variables)} vars)')


def _copy_attr(attributes: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attributes.items():
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
        elif isinstance(v, list):
            out[k] = list(v)
        else:
            out[k] = v
    return out


class GraphBuilder:
    """Frontend interface (ppq/IR/base/graph.py:924)."""

    def build(self, *args, **kwargs) -> BaseGraph:
        raise NotImplementedError


class GraphExporter:
    """Backend interface (ppq/IR/base/graph.py:930)."""

    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        raise NotImplementedError
