"""Frontends/backends: parsers build a BaseGraph, exporters write deployment
artifacts (port of ppq_tpu/frontends/__init__.py; reference layer:
ppq/parser/, registries at ppq/lib/common.py:47-78).

Parsers and exporters run on the host: they read and write files and the
TQCs' host scales, never `device_qparams`.
"""

from ..core import TargetPlatform
from .native import NativeExporter, NativeImporter
from .onnx import OnnxExporter, OnnxParser, load_onnx_graph

PARSER_COLLECTION = {
    'onnx': OnnxParser,
    'native': NativeImporter,
}


def _register_caffe():
    from .caffe import (CaffeExporter, CaffeParser, PPLDSPCaffeExporter,
                        PPLDSPTICaffeExporter, SNPECaffeExporter)
    PARSER_COLLECTION['caffe'] = CaffeParser
    # reference bindings (caffe_exporter.py flavors): DSP embeds quant
    # ranges in the prototxt, TI adds per-channel filter ranges, SNPE ships
    # caffe files + activation-encodings JSON
    EXPORTER_COLLECTION[TargetPlatform.TPU_DSP_INT8] = PPLDSPCaffeExporter
    EXPORTER_COLLECTION[TargetPlatform.PPL_DSP_TI_INT8] = \
        PPLDSPTICaffeExporter
    EXPORTER_COLLECTION[TargetPlatform.SNPE_INT8] = SNPECaffeExporter
    EXPORTER_COLLECTION.setdefault(TargetPlatform.CAFFE, CaffeExporter)


EXPORTER_COLLECTION = {
    TargetPlatform.ONNX: OnnxExporter,
    TargetPlatform.FP32: OnnxExporter,
}


def register_network_parser(parser_cls, name: str):
    PARSER_COLLECTION[name] = parser_cls


def register_network_exporter(exporter_cls, platform: TargetPlatform):
    """(reference: ppq/lib/extension.py register_network_exporter)"""
    EXPORTER_COLLECTION[platform] = exporter_cls


def _register_default_exporters():
    from .onnxruntime import ONNXRuntimeExporter, QDQHelper  # noqa: F401
    for p in (TargetPlatform.TPU_INT8, TargetPlatform.TPU_FP8,
              TargetPlatform.TPU_DSP_INT8, TargetPlatform.TPU_POWER_OF_2,
              TargetPlatform.TPU_INT4_WEIGHT_ONLY,
              TargetPlatform.ORT_INT8, TargetPlatform.TRT_INT8,
              TargetPlatform.TRT_FP8, TargetPlatform.OPENVINO_INT8,
              TargetPlatform.METAX_INT8_C, TargetPlatform.METAX_INT8_T,
              TargetPlatform.GRAPHCORE_FP8):
        EXPORTER_COLLECTION.setdefault(p, ONNXRuntimeExporter)
    from .qtable import (AscendExporter, ExtensionExporter, MNNExporter,
                         NCNNExporter, NXPExporter, PPLExporter,
                         RKNNExporter, SNPEExporter, TengineExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.NCNN_INT8, NCNNExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.MNN_INT8, MNNExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.SNPE_INT8, SNPEExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.RKNN_INT8, RKNNExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.TENGINE_INT8, TengineExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.ASCEND_INT8, AscendExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.NXP_INT8, NXPExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.FPGA_INT8, NXPExporter)
    EXPORTER_COLLECTION.setdefault(TargetPlatform.EXTENSION,
                                   ExtensionExporter)
    from .tensorrt import TensorRTExporter_JSON, TensorRTExporter_QDQ
    EXPORTER_COLLECTION[TargetPlatform.TRT_INT8] = TensorRTExporter_QDQ
    EXPORTER_COLLECTION.setdefault(TargetPlatform.PPL_CUDA_INT8
                                   if hasattr(TargetPlatform, 'PPL_CUDA_INT8')
                                   else TargetPlatform.TRT_INT8,
                                   TensorRTExporter_QDQ)


_register_default_exporters()
_register_caffe()
