"""TensorRT exporters (port of ppq_tpu/frontends/tensorrt.py; redesign of
ppq/parser/tensorRT.py:140).

Two flavors:
  * TensorRTExporter_QDQ — QDQ onnx (TensorRT consumes QuantizeLinear/
    DequantizeLinear natively); delegates to the QDQ exporter.
  * TensorRTExporter_JSON — fp32 onnx + engine-JSON with per-tensor dynamic
    ranges (the `utils/write_qparams_onnx2trt.py` flow: build-time
    setDynamicRange on every calibrated tensor).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..core import TargetPlatform
from ..ir import BaseGraph, GraphExporter
from .onnxruntime import ONNXRuntimeExporter
from .qtable import _range_of, _write_onnx, collect_exportable


class TensorRTExporter_QDQ(ONNXRuntimeExporter):
    """(reference tensorRT.py TensorRTExporter_QDQ)"""


class TensorRTExporter_JSON(GraphExporter):
    """(reference tensorRT.py TensorRTExporter_JSON +
    utils/write_qparams_onnx2trt.py)"""

    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        _write_onnx(graph, file_path)
        json_path = config_path or os.path.splitext(file_path)[0] + \
            '_trt_ranges.json'
        act_quant_info = {}
        for name, is_param, op, cfg in collect_exportable(graph):
            if is_param:
                continue
            lo, hi = _range_of(cfg)
            # TensorRT dynamic range is symmetric: amax
            act_quant_info[name] = float(np.max(np.abs([lo, hi])))
        with open(json_path, 'w') as f:
            json.dump({'act_quant_info': act_quant_info}, f, indent=2)
