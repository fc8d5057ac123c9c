"""Top-level API (port of ppq_tpu/api/interface.py).

quantize_graph is the one-call PTQ entry over a loaded graph:
format → dispatch → calibrate+optimize. Simulation runs on the
TorchExecutor, on the card unless the caller passes `device`.
ONNX/Caffe loading and export_ppq_graph are the frontends slice
(ROADMAP.md queue 1, item 5).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ..core import TargetPlatform, ppq_warning
from ..executor import TorchExecutor, resolve_device
from ..ir import BaseGraph, format_graph
from ..quantization.quantizer import QUANTIZER_COLLECTION, BaseQuantizer
from ..scheduler import DISPATCHER_TABLE
from .setting import QuantizationSetting, QuantizationSettingFactory

__all__ = [
    'format_graph', 'dispatch_graph', 'quantize_graph', 'manop',
    'DEQUANTIZE_GRAPH', 'QuantizationSetting', 'QuantizationSettingFactory',
]


def dispatch_graph(graph: BaseGraph, platform: TargetPlatform,
                   setting: Optional[QuantizationSetting] = None,
                   dispatcher: Optional[str] = None,
                   dispatching_table: Optional[Dict[str, int]] = None
                   ) -> BaseGraph:
    """Assign every op a TargetPlatform (reference api/interface.py:644-700)."""
    if setting is not None:
        dispatcher = dispatcher or setting.dispatcher
        dispatching_table = dispatching_table or \
            setting.dispatching_table.dispatchings
    dispatcher = (dispatcher or 'conservative').lower()
    if dispatcher not in DISPATCHER_TABLE:
        raise KeyError(f'Unknown dispatcher {dispatcher!r}; '
                       f'choose from {sorted(DISPATCHER_TABLE)}')

    quantizer_cls = QUANTIZER_COLLECTION.get(platform)
    quant_types = quantizer_cls.quant_operation_types if quantizer_cls else None

    table = DISPATCHER_TABLE[dispatcher](graph).dispatch(
        quant_types=quant_types, quant_platform=platform,
        fp32_platform=TargetPlatform.FP32,
        soi_platform=TargetPlatform.SOI)

    if dispatching_table:
        for op_name, plat in dispatching_table.items():
            if op_name not in graph.operations:
                ppq_warning(f'Dispatching table names unknown op {op_name!r}')
                continue
            table[op_name] = TargetPlatform(plat)

    for name, op in graph.operations.items():
        op.platform = table[name]
    return graph


def quantize_graph(graph: BaseGraph, calib_dataloader: Iterable,
                   calib_steps: int = 32,
                   input_shape: Optional[List[int]] = None,
                   inputs: Optional[Any] = None,
                   platform: TargetPlatform = TargetPlatform.TPU_INT8,
                   setting: Optional[QuantizationSetting] = None,
                   collate_fn: Optional[Callable] = None,
                   do_quantize: bool = True,
                   verbose: bool = True, device=None) -> BaseGraph:
    """Core PTQ flow over an already-loaded BaseGraph
    (reference api/interface.py:185-278 minus the onnx load). Calibration
    runs on `device`, the card by default."""
    device = resolve_device(device)
    if setting is None:
        setting = QuantizationSettingFactory.default_setting()
    setting.calibration.calib_steps = calib_steps

    format_graph(graph)
    if not do_quantize:
        return graph

    dispatch_graph(graph, platform, setting)

    if inputs is None:
        if input_shape is not None:
            inputs = np.zeros(input_shape, np.float32)
        else:
            # take the first calibration batch as the tracing sample
            first = next(iter(calib_dataloader))
            inputs = collate_fn(first) if collate_fn is not None else first

    executor = TorchExecutor(graph, device=device)
    quantizer_cls = QUANTIZER_COLLECTION.get(platform)
    if quantizer_cls is None:
        raise KeyError(f'No quantizer registered for platform {platform.name}')
    quantizer: BaseQuantizer = quantizer_cls(graph)
    quantizer.quantize(executor=executor, dataloader=calib_dataloader,
                       setting=setting, collate_fn=collate_fn,
                       inputs=inputs, verbose=verbose)
    return graph


class DEQUANTIZE_GRAPH:
    """Temporarily disable all quantization on a graph
    (reference api/interface.py:957)."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def __enter__(self):
        from ..ir import dequantize_graph
        dequantize_graph(self.graph)
        return self.graph

    def __exit__(self, *exc):
        from ..ir import restore_graph_quantization
        restore_graph_quantization(self.graph)


def manop(graph: BaseGraph, list_of_passes, calib_dataloader=None,
          executor=None, collate_fn=None, verbose: bool = True,
          device=None) -> BaseGraph:
    """Manually apply optimization passes (reference api/interface.py:870).
    Without an executor, one is made on `device`, the card by default."""
    from ..quantization.optim import (QuantizationOptimizationPass,
                                      QuantizationOptimizationPipeline)
    if isinstance(list_of_passes, QuantizationOptimizationPass):
        list_of_passes = [list_of_passes]
    if executor is None:
        executor = TorchExecutor(graph, device=device)
    pipeline = QuantizationOptimizationPipeline(list(list_of_passes))
    pipeline.optimize(graph, dataloader=calib_dataloader, executor=executor,
                      collate_fn=collate_fn, verbose=verbose)
    return graph
