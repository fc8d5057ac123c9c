"""Executor base: per-platform forward tables, handler registry, runtime
hooks (redesign of ppq/executor/base.py:12-179)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core import TargetPlatform, TensorQuantizationConfig
from ..ir import BaseGraph, Operation
from .ops.default import DEFAULT_BACKEND_TABLE

# {platform → {op_type → forward fn}}; platforms fall back to the default
# table — platform tables only hold overrides (reference keeps full copies,
# executor/base.py:14-22; overrides are cleaner and stay in sync).
OPERATION_FORWARD_TABLE: Dict[TargetPlatform, Dict[str, Callable]] = {
    platform: {} for platform in TargetPlatform
}


def resolve_forward(platform: TargetPlatform, op_type: str) -> Callable:
    table = OPERATION_FORWARD_TABLE.get(platform, {})
    if op_type in table:
        return table[op_type]
    if op_type not in DEFAULT_BACKEND_TABLE:
        raise NotImplementedError(
            f'No forward implementation for op type {op_type!r} '
            f'(platform {platform.name}). Register one via '
            f'register_operation_handler().')
    return DEFAULT_BACKEND_TABLE[op_type]


def register_operation_handler(handler: Callable, operation_type: str,
                               platform: Optional[TargetPlatform] = None):
    """(reference: executor/base.py:25) platform=None registers the default."""
    if platform is None:
        DEFAULT_BACKEND_TABLE[operation_type] = handler
    else:
        OPERATION_FORWARD_TABLE[platform][operation_type] = handler


class RuntimeHook:
    """Observation point around one op's execution
    (reference: executor/base.py:44)."""

    def __init__(self, operation: Operation):
        self._hook_to = operation

    def pre_forward_hook(self, inputs: list, **kwargs) -> list:
        return inputs

    def post_forward_hook(self, outputs: list, **kwargs) -> list:
        return outputs


class QuantRuntimeHook(RuntimeHook):
    """Hook that also sees pre-quant values and quant configs
    (reference: executor/base.py:76)."""

    def pre_forward_hook(self, inputs: list, quant_inputs: list = None,
                         quant_configs: List[TensorQuantizationConfig] = None,
                         **kwargs) -> list:
        return quant_inputs if quant_inputs is not None else inputs

    def post_forward_hook(self, outputs: list, quant_outputs: list = None,
                          quant_configs: List[TensorQuantizationConfig] = None,
                          **kwargs) -> list:
        return quant_outputs if quant_outputs is not None else outputs


class BaseGraphExecutor:
    """(reference: executor/base.py:105)"""

    def __init__(self, graph: BaseGraph):
        self._graph: Optional[BaseGraph] = None
        self._executing_order: List[Operation] = []
        self.load_graph(graph)

    def load_graph(self, graph: BaseGraph):
        self._graph = graph
        self._executing_order = graph.topological_sort()

    @property
    def graph(self) -> BaseGraph:
        return self._graph

    def refresh(self):
        """Re-sort after graph surgery."""
        self._executing_order = self._graph.topological_sort()

    def forward(self, *args, **kwargs):
        raise NotImplementedError
