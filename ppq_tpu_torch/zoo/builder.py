"""Small DSL for building ONNX-semantic graphs in-repo.

The environment has no torchvision/onnx model zoo and zero egress, so test
and benchmark models (ResNet-18, MobileNetV2, ...) are constructed here with
deterministic random weights. Graphs use ONNX conventions (NCHW, opset 13),
so they exercise exactly the code paths a real exported model would.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core import DataType
from ..ir import BaseGraph, Operation, Variable


class NetBuilder:
    def __init__(self, name: str, seed: int = 0):
        self.g = BaseGraph(name)
        self.rng = np.random.RandomState(seed)
        self._n = 0

    # ------------------------------------------------------------ plumbing
    def _name(self, prefix: str) -> str:
        self._n += 1
        return f'{prefix}_{self._n}'

    def input(self, name: str, shape: Sequence[int]) -> Variable:
        var = self.g.create_variable(name, shape=list(shape))
        self.g.mark_as_input(var)
        return var

    def output(self, var: Variable) -> Variable:
        self.g.mark_as_output(var)
        return var

    def param(self, value: np.ndarray, name: Optional[str] = None) -> Variable:
        return self.g.create_variable(name or self._name('p'),
                                      value=value.astype(np.float32),
                                      is_parameter=True)

    def iparam(self, value: np.ndarray, name: Optional[str] = None) -> Variable:
        return self.g.create_variable(name or self._name('i'),
                                      value=np.asarray(value, np.int64),
                                      is_parameter=True)

    def op(self, op_type: str, inputs: List[Variable], n_out: int = 1,
           **attributes) -> Variable:
        name = self._name(op_type.lower())
        o = self.g.create_operation(op_type, name=name,
                                    attributes=attributes, inputs=inputs)
        outs = [self.g.create_variable(f'{name}_out{i}' if n_out > 1 else f'{name}_out',
                                       source_op=o) for i in range(n_out)]
        return outs[0] if n_out == 1 else outs

    # ------------------------------------------------------------- layers
    def conv(self, x: Variable, cin: int, cout: int, k: int = 3, stride: int = 1,
             pad: Optional[int] = None, group: int = 1, bias: bool = False) -> Variable:
        if pad is None:
            pad = k // 2
        fan_in = (cin // group) * k * k
        w = self.param(self.rng.randn(cout, cin // group, k, k)
                       * np.sqrt(2.0 / fan_in))
        inputs = [x, w]
        if bias:
            inputs.append(self.param(self.rng.randn(cout) * 0.01))
        return self.op('Conv', inputs, kernel_shape=[k, k],
                       strides=[stride, stride], pads=[pad, pad, pad, pad],
                       group=group, dilations=[1, 1])

    def bn(self, x: Variable, c: int) -> Variable:
        return self.op('BatchNormalization', [
            x,
            self.param(self.rng.rand(c) * 0.5 + 0.75),   # gamma
            self.param(self.rng.randn(c) * 0.1),         # beta
            self.param(self.rng.randn(c) * 0.1),         # running mean
            self.param(self.rng.rand(c) * 0.5 + 0.5),    # running var
        ], epsilon=1e-5)

    def relu(self, x: Variable) -> Variable:
        return self.op('Relu', [x])

    def relu6(self, x: Variable) -> Variable:
        lo = self.param(np.asarray(0.0, np.float32))
        hi = self.param(np.asarray(6.0, np.float32))
        return self.op('Clip', [x, lo, hi])

    def add(self, a: Variable, b: Variable) -> Variable:
        return self.op('Add', [a, b])

    def maxpool(self, x: Variable, k: int, stride: int, pad: int = 0) -> Variable:
        return self.op('MaxPool', [x], kernel_shape=[k, k],
                       strides=[stride, stride], pads=[pad, pad, pad, pad])

    def gap(self, x: Variable) -> Variable:
        return self.op('GlobalAveragePool', [x])

    def flatten(self, x: Variable) -> Variable:
        return self.op('Flatten', [x], axis=1)

    def gemm(self, x: Variable, cin: int, cout: int, bias: bool = True) -> Variable:
        w = self.param(self.rng.randn(cin, cout) * np.sqrt(2.0 / cin))
        inputs = [x, w]
        if bias:
            inputs.append(self.param(self.rng.randn(cout) * 0.01))
        return self.op('Gemm', inputs, alpha=1.0, beta=1.0, transA=0, transB=0)

    def softmax(self, x: Variable, axis: int = -1) -> Variable:
        return self.op('Softmax', [x], axis=axis)

    def matmul(self, a: Variable, b: Variable) -> Variable:
        return self.op('MatMul', [a, b])

    def reshape(self, x: Variable, shape: Sequence[int]) -> Variable:
        return self.op('Reshape', [x, self.iparam(np.asarray(shape))])

    def transpose(self, x: Variable, perm: Sequence[int]) -> Variable:
        return self.op('Transpose', [x], perm=list(perm))

    def concat(self, xs: List[Variable], axis: int) -> Variable:
        return self.op('Concat', xs, axis=axis)
