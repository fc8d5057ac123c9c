"""Top-level API (port of ppq_tpu/api/interface.py).

quantize_onnx_model / quantize_graph are the one-call PTQ entries:
load → format → dispatch → calibrate+optimize, then export_ppq_graph
writes the deployable file. Simulation runs on the TorchExecutor, on the
card unless the caller passes `device`; loading and export run on the
host.

The JAX package's ENABLE_PALLAS_KERNEL / DISABLE_PALLAS_KERNEL have no
counterpart: on a CUDA tensor the port launches its kernel or raises, and a
switch to the plain versions would be a fallback on the card.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from ..core import TargetPlatform, load_native, ppq_info, ppq_warning
from ..executor import TorchExecutor, resolve_device
from ..frontends.onnx import load_onnx_graph
from ..ir import BaseGraph, format_graph
from ..quantization.quantizer import QUANTIZER_COLLECTION, BaseQuantizer
from ..scheduler import DISPATCHER_TABLE
from .setting import QuantizationSetting, QuantizationSettingFactory

__all__ = [
    'load_onnx_graph', 'load_native_graph', 'load_graph', 'format_graph',
    'dispatch_graph', 'quantize_onnx_model', 'quantize_graph',
    'quantize_native_model', 'quantize_caffe_model', 'load_caffe_graph',
    'quantize_torch_model', 'load_torch_model',
    'export_ppq_graph', 'quantize', 'export', 'manop',
    'DEQUANTIZE_GRAPH', 'QuantizationSetting', 'QuantizationSettingFactory',
]


def load_native_graph(import_file: str) -> BaseGraph:
    """Load a .native checkpoint (reference api/interface.py:66)."""
    return load_native(import_file)


def load_graph(path: str) -> BaseGraph:
    if path.endswith('.onnx'):
        return load_onnx_graph(path)
    if path.endswith('.native'):
        return load_native_graph(path)
    raise ValueError(f'Cannot infer graph format from {path!r} '
                     f'(expected .onnx or .native)')


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


def quantize_onnx_model(onnx_import_file: str, calib_dataloader: Iterable,
                        calib_steps: int = 32,
                        input_shape: Optional[List[int]] = None,
                        inputs: Optional[Any] = None,
                        platform: TargetPlatform = TargetPlatform.TPU_INT8,
                        setting: Optional[QuantizationSetting] = None,
                        collate_fn: Optional[Callable] = None,
                        do_quantize: bool = True,
                        verbose: bool = True, device=None) -> BaseGraph:
    """The main PTQ entry (reference api/interface.py:185): parse the file
    on the host, calibrate on `device`, the card by default."""
    device = resolve_device(device)
    graph = load_onnx_graph(onnx_import_file)
    return quantize_graph(graph, calib_dataloader, calib_steps=calib_steps,
                          input_shape=input_shape, inputs=inputs,
                          platform=platform, setting=setting,
                          collate_fn=collate_fn, do_quantize=do_quantize,
                          verbose=verbose, device=device)


def quantize_native_model(native_import_file: str, calib_dataloader: Iterable,
                          **kwargs) -> BaseGraph:
    """(reference api/interface.py:453)"""
    graph = load_native_graph(native_import_file)
    return quantize_graph(graph, calib_dataloader, **kwargs)


def load_torch_model(model, sample_input, onnx_save_path: Optional[str] = None
                     ) -> BaseGraph:
    """Export a torch.nn.Module through torch.onnx (the TorchScript
    exporter, `dynamo=False`) and parse it (reference api/interface.py:279
    quantize_torch_model's load step). Without an `onnx` package, the
    port's protobuf bindings stand in for the two symbols torch's
    serializer touches, for the span of the export only: a stand-in left in
    `sys.modules` would break later imports that probe for `onnx` (Adam's
    first import of torch._dynamo)."""
    import sys
    import tempfile
    import types

    import torch
    from ..frontends.onnx import onnx_pb2 as pb
    planted = 'onnx' not in sys.modules
    if planted:
        shim = types.ModuleType('onnx')
        shim.ModelProto = pb.ModelProto
        shim.load_model_from_string = pb.ModelProto.FromString
        sys.modules['onnx'] = shim
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = onnx_save_path or os.path.join(tmp, 'model.onnx')
            torch.onnx.export(model.eval(), (sample_input,), path,
                              opset_version=13, dynamo=False)
            return load_onnx_graph(path)
    finally:
        if planted:
            sys.modules.pop('onnx', None)


def quantize_torch_model(model, calib_dataloader: Iterable,
                         sample_input=None, **kwargs) -> BaseGraph:
    """(reference api/interface.py:279)"""
    if sample_input is None:
        import torch
        first = next(iter(calib_dataloader))
        sample_input = torch.as_tensor(np.asarray(first))
    graph = load_torch_model(model, sample_input)
    return quantize_graph(graph, calib_dataloader, **kwargs)


def load_caffe_graph(prototxt_path: str, caffemodel_path=None) -> BaseGraph:
    """(reference api/interface.py:28 load_caffe_graph)"""
    from ..frontends.caffe import load_caffe_graph as _load
    return _load(prototxt_path, caffemodel_path)


def quantize_caffe_model(caffe_proto_file: str, caffe_model_file: str,
                         calib_dataloader: Iterable, **kwargs) -> BaseGraph:
    """(reference api/interface.py:349)"""
    graph = load_caffe_graph(caffe_proto_file, caffe_model_file)
    return quantize_graph(graph, calib_dataloader, **kwargs)


def quantize(working_directory: str, setting: QuantizationSetting,
             input_shape: List[int], target_platform: TargetPlatform,
             dataloader: Optional[Iterable] = None,
             calib_steps: int = 32, model_type: str = 'onnx',
             verbose: bool = True, device=None) -> BaseGraph:
    """Beginner working-directory flow (reference api/interface.py:805):
    quantize `<working_directory>/model.onnx` (or model.prototxt +
    model.caffemodel with model_type='caffe'). When no dataloader is
    given, calibration batches load from `<working_directory>/data/*.npy`
    via fsys.load_calibration_dataset. Calibration runs on `device`, the
    card by default."""
    from .fsys import load_calibration_dataset
    device = resolve_device(device)
    model_type = model_type.lower()
    if dataloader is None:
        batch = input_shape[0] if input_shape and input_shape[0] else 32
        dataloader = load_calibration_dataset(
            working_directory, input_shape, batchsize=batch)
        calib_steps = min(calib_steps, len(dataloader))
    if model_type == 'onnx':
        path = os.path.join(working_directory, 'model.onnx')
        if not os.path.exists(path):
            raise FileNotFoundError(
                f'Cannot find your model at {path!r}; for caffe models '
                f'pass model_type="caffe"')
        return quantize_onnx_model(
            onnx_import_file=path, calib_dataloader=dataloader,
            calib_steps=calib_steps, input_shape=input_shape,
            setting=setting, platform=target_platform, verbose=verbose,
            device=device)
    if model_type == 'caffe':
        path = os.path.join(working_directory, 'model.caffemodel')
        proto = os.path.join(working_directory, 'model.prototxt')
        if not os.path.exists(path):
            raise FileNotFoundError(
                f'Cannot find your model at {path!r}; for onnx models '
                f'pass model_type="onnx"')
        if not os.path.exists(proto):
            raise FileNotFoundError(
                f'Cannot find your model at {proto!r}; caffe models need '
                f'both model.prototxt and model.caffemodel')
        return quantize_caffe_model(
            caffe_proto_file=proto,
            caffe_model_file=path, calib_dataloader=dataloader,
            calib_steps=calib_steps, input_shape=input_shape,
            setting=setting, platform=target_platform, verbose=verbose,
            device=device)
    raise ValueError(f'model_type must be "onnx" or "caffe", '
                     f'got {model_type!r}')


def export(working_directory: str, quantized: BaseGraph,
           platform: TargetPlatform, **kwargs) -> None:
    """Beginner working-directory export (reference api/interface.py:852):
    writes `<working_directory>/quantized.<ext>` + `quantized.json`."""
    export_ppq_graph(
        graph=quantized, platform=platform,
        graph_save_to=os.path.join(working_directory, 'quantized'),
        config_save_to=os.path.join(working_directory, 'quantized.json'),
        **kwargs)


def export_ppq_graph(graph: BaseGraph, platform: TargetPlatform,
                     graph_save_to: str,
                     config_save_to: Optional[str] = None,
                     **kwargs) -> None:
    """Export quantized graph + qparams for a deployment backend
    (reference api/interface.py:546). Runs on the host: the exporters read
    the TQCs' host scales."""
    from ..frontends import EXPORTER_COLLECTION
    exporter_cls = EXPORTER_COLLECTION.get(platform)
    if exporter_cls is None:
        raise KeyError(f'No exporter registered for platform {platform.name}; '
                       f'available: {[p.name for p in EXPORTER_COLLECTION]}')
    exporter = exporter_cls()
    exporter.export(file_path=graph_save_to, graph=graph,
                    config_path=config_save_to, **kwargs)
    ppq_info(f'Graph exported to {graph_save_to} '
             f'({type(exporter).__name__})')


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
