"""Quant-table exporters for table-driven backends
(port of ppq_tpu/frontends/qtable.py; redesign of
ppq/parser/{ppl,ncnn,tengine,mnn,openvino,nxp,qnn,ascend}
exporters, 69-246 LoC each — each writes the backend's quant-parameter
table next to a plain ONNX model).

Every exporter here emits: (1) the fp32 ONNX model (the backend's own
converter re-quantizes it), and (2) the backend-specific quant table
derived from the exportable TQCs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import QuantizationStates, TensorQuantizationConfig
from ..ir import BaseGraph, GraphExporter, QuantableOperation
from .onnx import graph_to_model_proto


def collect_exportable(graph: BaseGraph):
    """(var_name, is_parameter, op, cfg) for every exportable root TQC."""
    seen = set()
    out = []
    for op in graph.operations.values():
        if not isinstance(op, QuantableOperation):
            continue
        for var, cfg in op.config_pairs():
            if var.name in seen:
                continue
            if cfg.state == QuantizationStates.OVERLAPPED:
                continue
            if not cfg.can_export or not cfg.dominated_by.has_scale:
                continue
            if cfg.state == QuantizationStates.FP32:
                continue
            seen.add(var.name)
            out.append((var.name, var.is_parameter, op, cfg))
    return out


def _write_onnx(graph: BaseGraph, file_path: str):
    model = graph_to_model_proto(graph)
    with open(file_path, 'wb') as f:
        f.write(model.SerializeToString())


def _range_of(cfg: TensorQuantizationConfig) -> Tuple[np.ndarray, np.ndarray]:
    scale = np.asarray(cfg.scale, np.float64)
    offset = np.asarray(cfg.offset, np.float64)
    lo = (cfg.quant_min - offset) * scale
    hi = (cfg.quant_max - offset) * scale
    return lo, hi


class _TableExporter(GraphExporter):
    table_suffix = '.table'

    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        _write_onnx(graph, file_path)
        table_path = config_path or (os.path.splitext(file_path)[0]
                                     + self.table_suffix)
        self.write_table(graph, table_path)

    def write_table(self, graph: BaseGraph, path: str):
        raise NotImplementedError


class NCNNExporter(_TableExporter):
    """ncnn int8 table (reference ppq/parser/ncnn_exporter.py format,
    byte-compatible): FIRST one `<op>_param_0` line per computing op with
    the inverse per-channel weight scales (depthwise convs collapse to one
    scale per group — ncnn's layout), THEN one `<op>` line per computing op
    with the inverse per-tensor INPUT scale. '%f' formatting with trailing
    space, like the reference's `fd.write('%f '% s)` loop."""

    def write_table(self, graph: BaseGraph, path: str):
        topo = [op for op in graph.topological_sort()
                if op.is_computing_op and isinstance(op, QuantableOperation)]
        lines = []
        for op in topo:
            if len(op.config.input_quantization_config) < 2:
                continue
            cfg = op.config.input_quantization_config[1].dominated_by
            if not cfg.has_scale:
                continue
            scale = np.atleast_1d(np.asarray(cfg.scale, np.float64))
            group = int(op.attributes.get('group', 1))
            if op.type == 'Conv' and group > 1:
                scale = scale.reshape(group, -1).max(axis=1)
            inv = 1.0 / np.maximum(scale, 1e-30)
            lines.append(f'{op.name}_param_0 ' +
                         ''.join('%f ' % v for v in inv))
        for op in topo:
            cfg = op.config.input_quantization_config[0].dominated_by
            if not cfg.has_scale:
                continue
            inv = 1.0 / max(float(np.asarray(cfg.scale).reshape(-1)[0]),
                            1e-30)
            lines.append(f'{op.name} ' + '%f ' % inv)
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')


class TengineExporter(_TableExporter):
    """Tengine quant config (reference ppq/parser/tengine_exporter.py:91):
    a JSON render buffer {configs, dispatchings, values} — per-op per-var
    TQC descriptors with hash/dominator links, root scales under `values`.
    Per-channel configs are rejected (Tengine limitation, reference
    line 113)."""

    table_suffix = '.json'

    def write_table(self, graph: BaseGraph, path: str):
        buf = {'configs': {}, 'dispatchings': {}, 'values': {}}
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            op_dict = {}
            for var, cfg in op.config_pairs():
                if cfg.policy.per_channel:
                    raise PermissionError(
                        'Tengine does not support per-channel quantization.')
                op_dict[var.name] = {
                    'bit_width': cfg.num_of_bits,
                    'policy': cfg.policy.to_dict(),
                    'state': cfg.state.name,
                    'quant_min': cfg.quant_min,
                    'quant_max': cfg.quant_max,
                    'hash': hash(cfg),
                    'dominator': hash(cfg.dominated_by),
                }
                root = cfg.dominated_by
                if root is cfg and root.has_scale:
                    buf['values'][hash(cfg)] = {
                        'scale': float(np.asarray(root.scale)
                                       .reshape(-1)[0]),
                        'zero_point': float(np.asarray(root.offset)
                                            .reshape(-1)[0]),
                    }
            buf['configs'][op.name] = op_dict
            buf['dispatchings'][op.name] = op.platform.name
        with open(path, 'w') as f:
            json.dump(buf, f, indent=4)


class SNPEExporter(_TableExporter):
    """SNPE/DSP encodings JSON: per-tensor {min, max, scale, offset, bw}
    (reference: ppq/parser/caffe_exporter.py SNPECaffeExporter +
    utils/write_qparams_to_snpe_dlc.py)."""

    table_suffix = '_encodings.json'

    def write_table(self, graph: BaseGraph, path: str):
        acts, params = {}, {}
        for name, is_param, op, cfg in collect_exportable(graph):
            lo, hi = _range_of(cfg)
            rec = [{
                'bitwidth': cfg.num_of_bits,
                'min': float(np.min(lo)), 'max': float(np.max(hi)),
                'scale': float(np.max(np.asarray(cfg.scale))),
                'offset': int(np.round(np.mean(np.asarray(cfg.offset)))),
            }]
            (params if is_param else acts)[name] = rec
        with open(path, 'w') as f:
            json.dump({'activation_encodings': acts,
                       'param_encodings': params}, f, indent=2)


class MNNExporter(_TableExporter):
    """MNN quant json (reference: ppq/parser/mnn_exporter.py)."""

    table_suffix = '_quant.json'

    def write_table(self, graph: BaseGraph, path: str):
        recs = []
        for name, is_param, op, cfg in collect_exportable(graph):
            recs.append({
                'tensor': name, 'op': op.name, 'type': op.type,
                'bits': cfg.num_of_bits,
                'scale': np.atleast_1d(np.asarray(cfg.scale)).tolist(),
                'zero': np.atleast_1d(np.asarray(cfg.offset)).astype(int).tolist(),
                'per_channel': bool(cfg.policy.per_channel),
            })
        with open(path, 'w') as f:
            json.dump(recs, f, indent=2)


class RKNNExporter(MNNExporter):
    """RKNN quant config json (reference: ppq/parser/extension.py RKNN path)."""
    table_suffix = '_rknn_quant.json'


class AscendExporter(MNNExporter):
    """Ascend AMCT-style record file (reference: ppq/parser/ascend_exporter.py)."""
    table_suffix = '_ascend_quant.json'


class NXPExporter(_TableExporter):
    """NXP/FPGA power-of-2 table: exponent per tensor
    (reference: ppq/parser/nxp_exporter.py)."""

    table_suffix = '_po2.table'

    def write_table(self, graph: BaseGraph, path: str):
        lines = []
        for name, is_param, op, cfg in collect_exportable(graph):
            scale = np.atleast_1d(np.asarray(cfg.scale, np.float64))
            exps = np.round(np.log2(np.maximum(scale, 1e-30))).astype(int)
            lines.append(f'{name} ' + ' '.join(str(e) for e in exps))
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')


class PPLExporter(_TableExporter):
    """PPL backend scale json (reference: ppq/parser/ppl.py:72)."""

    table_suffix = '_ppl_quant.json'

    def write_table(self, graph: BaseGraph, path: str):
        quant_info = {}
        for name, is_param, op, cfg in collect_exportable(graph):
            lo, hi = _range_of(cfg)
            quant_info[name] = {
                'bit_width': cfg.num_of_bits,
                'per_channel': bool(cfg.policy.per_channel),
                'quant_flag': True,
                'scale': np.atleast_1d(np.asarray(cfg.scale)).tolist(),
                'zero_point': np.atleast_1d(np.asarray(cfg.offset)).tolist(),
                'tensor_min': np.atleast_1d(lo).tolist(),
                'tensor_max': np.atleast_1d(hi).tolist(),
            }
        with open(path, 'w') as f:
            json.dump({'quant_info': quant_info}, f, indent=2)


class ExtensionExporter(_TableExporter):
    """User-extensible exporter stub (reference: ppq/parser/extension.py
    ExtensionExporter — "rewrite function export in order to dump ppq
    graph to disk"). The sample behavior matches the reference: every
    exportable TQC's quant params land in a plain txt next to an fp32
    ONNX model. Subclass and override write_table (or export) for a
    custom backend format; register with
    ppq_tpu_torch.frontends.register_network_exporter(
    exporter, TargetPlatform.EXTENSION).
    """

    table_suffix = '_quant_params.txt'

    def write_table(self, graph: BaseGraph, path: str):
        lines = []
        for name, is_param, op, cfg in collect_exportable(graph):
            scale = np.atleast_1d(np.asarray(cfg.scale, np.float64))
            offset = np.atleast_1d(np.asarray(cfg.offset, np.float64))
            lines.append(f'{name}\tbits={cfg.num_of_bits}\t'
                         f'policy={cfg.policy.to_dict()}\t'
                         f'scale={scale.tolist()}\t'
                         f'offset={offset.tolist()}')
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')
