from . import fsys
from .interface import (DEQUANTIZE_GRAPH, dispatch_graph, export,
                        export_ppq_graph, format_graph, load_caffe_graph,
                        load_graph, load_native_graph, load_onnx_graph,
                        load_torch_model, manop, quantize,
                        quantize_caffe_model, quantize_graph,
                        quantize_native_model, quantize_onnx_model,
                        quantize_torch_model)
from .setting import (QuantizationSetting, QuantizationSettingFactory,
                      UnbelievableUserFriendlyQuantizationSetting)

__all__ = [
    'DEQUANTIZE_GRAPH', 'dispatch_graph', 'export_ppq_graph', 'format_graph',
    'load_graph', 'load_native_graph', 'load_onnx_graph', 'manop',
    'quantize_graph', 'quantize_native_model', 'quantize_onnx_model',
    'quantize_caffe_model', 'load_caffe_graph', 'quantize_torch_model',
    'load_torch_model', 'quantize', 'export', 'fsys',
    'QuantizationSetting', 'QuantizationSettingFactory',
    'UnbelievableUserFriendlyQuantizationSetting',
]
