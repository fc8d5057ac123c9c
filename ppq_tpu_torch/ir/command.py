"""Graph command layer
(redesign of ppq/IR/base/command.py:8-165 + processer.py:9-187).

The reference routes all graph surgery through GraphCommand objects handled
by a chain of GraphCommandProcessors. In this codebase the morphs are plain
functions (ir/morph.py) — simpler and jit-friendlier — but the command
surface is kept for API parity and for callers that script pipelines of
graph edits declaratively.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional

from ..core import ppq_warning
from .graph import BaseGraph


class GraphCommandType(enum.Enum):
    """(reference IR/base/command.py:8-112 — the subset with runtime effect
    in this framework.)"""

    FORMAT_CONSTANT_INPUT = 'format_constant_input'
    FORMAT_PARAMETER = 'format_parameter'
    FORMAT_CAST = 'format_cast'
    FORMAT_SLICE = 'format_slice'
    FORMAT_CLIP = 'format_clip'
    FORMAT_PAD = 'format_pad'
    FORMAT_RESIZE = 'format_resize'
    FORMAT_INT64_CONSTANT = 'format_int64_constants'
    REMOVE_IDENTITY = 'remove_identity'
    DELETE_ISOLATED = 'delete_isolated'
    FUSE_BN = 'fuse_bn'
    FUSE_BIAS_ADD = 'fuse_bias_add'
    FUSE_GELU = 'fuse_gelu'
    FUSE_LAYERNORM = 'fuse_layernorm'
    FUSE_SKIPLAYERNORM = 'fuse_skiplayernorm'
    FUSE_SELFATTENTION = 'fuse_selfattention'
    FUSE_MATMUL_ADD = 'fuse_matmul_add'
    FUSE_SCALE = 'fuse_scale'
    DECOMPOSE_GEMM = 'decompose_gemm'
    DECOMPOSE_GRU = 'decompose_gru'
    # device commands (ir/deploy.py)
    DEPLOY_TO_CPU = 'deploy_to_cpu'
    DEPLOY_TO_DEVICE = 'deploy_to_device'
    INSERT_SWITCHER = 'insert_switcher'
    REMOVE_SWITCHER = 'remove_switcher'
    QUANTIZE_OPERATION = 'quantize_operation'


class GraphCommand:
    """(reference command.py:114)"""

    def __init__(self, command_type: GraphCommandType, **kwargs):
        self.command_type = command_type
        self.kwargs = kwargs

    def __repr__(self):
        return f'GraphCommand({self.command_type.value}, {self.kwargs})'


class QuantizeOperationCommand(GraphCommand):
    """(reference command.py: QuantizeOperationCommand)"""

    def __init__(self, op_name: str, config):
        super().__init__(GraphCommandType.QUANTIZE_OPERATION,
                         op_name=op_name, config=config)


class GraphCommandProcessor:
    """Chain-of-responsibility dispatcher (reference processer.py:9):
    subclasses declare `_acceptable_command_types` and implement `process`;
    unhandled commands flow to `_next_command_processor`."""

    def __init__(self, graph_or_processor):
        if isinstance(graph_or_processor, GraphCommandProcessor):
            self._graph = graph_or_processor._graph
            self._next_command_processor = graph_or_processor
        else:
            self._graph = graph_or_processor
            self._next_command_processor = None

    @property
    def graph(self) -> BaseGraph:
        return self._graph

    @property
    def _acceptable_command_types(self) -> List[GraphCommandType]:
        raise NotImplementedError

    def process(self, command: GraphCommand) -> Any:
        raise NotImplementedError

    def __call__(self, command: GraphCommand) -> Any:
        if command.command_type in self._acceptable_command_types:
            return self.process(command)
        if self._next_command_processor is not None:
            return self._next_command_processor(command)
        raise ValueError(
            f'No processor in the chain accepts {command.command_type}')


class DefaultGraphProcessor(GraphCommandProcessor):
    """Routes every structural command to its morph function."""

    @property
    def _acceptable_command_types(self) -> List[GraphCommandType]:
        return [t for t in GraphCommandType
                if t not in (GraphCommandType.QUANTIZE_OPERATION,)]

    def process(self, command: GraphCommand) -> Any:
        from . import deploy, morph
        name = command.command_type.value
        if name in ('deploy_to_cpu', 'deploy_to_device'):
            rg = deploy.RunnableGraph(self._graph)
            return (rg.retrieve() if name == 'deploy_to_cpu'
                    else rg.deploy(command.kwargs.get('device')))
        if name in ('insert_switcher', 'remove_switcher'):
            sw = deploy.GraphDeviceSwitcher(self._graph)
            return getattr(sw, name)()
        fn = getattr(morph, name, None)
        if fn is None:
            raise NotImplementedError(name)
        return fn(self._graph, **command.kwargs)


class QuantableGraphProcessor(GraphCommandProcessor):
    """(reference IR/quantize.py:259 QuantableGraph)"""

    @property
    def _acceptable_command_types(self) -> List[GraphCommandType]:
        return [GraphCommandType.QUANTIZE_OPERATION]

    def process(self, command: GraphCommand) -> Any:
        from .quantize import quantize_operation
        return quantize_operation(self._graph, command.kwargs['op_name'],
                                  command.kwargs['config'])


def default_command_chain(graph: BaseGraph) -> GraphCommandProcessor:
    """The standard processor chain (reference api/interface.py:593
    GraphReplacer(GraphFormatter(GraphMerger)) spelling)."""
    return QuantableGraphProcessor(DefaultGraphProcessor(graph))
