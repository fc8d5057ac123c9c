"""BaseGraph → Caffe exporter (port of ppq_tpu/frontends/caffe/exporter.py;
redesign of ppq/parser/caffe_exporter.py:561
+ caffe/caffe_export_utils.py:22 op exporters).

Writes <file>.prototxt (text NetParameter) + <file>.caffemodel (binary
weights). Quantized graphs additionally emit a qparams JSON sidecar via
config_path (matching the PPLDSP/SNPE caffe-exporter flavors which ship the
quant table next to the model).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
from google.protobuf import text_format

from ...core import QuantizationStates, ppq_warning
from ...ir import BaseGraph, GraphExporter, Operation, QuantableOperation
from . import caffe_pb2 as pb


def _set_blob(blob: 'pb.BlobProto', value: np.ndarray):
    value = np.asarray(value, np.float32)
    blob.shape.dim.extend(int(d) for d in value.shape)
    blob.data.extend(float(v) for v in value.reshape(-1))


def _channel_operand(value) -> Optional[np.ndarray]:
    """A parameter operand of an Add or Mul as the blob of a Caffe Scale or
    Bias layer (axis 1): one number, or one per channel of an NCHW tensor
    ((1, C, 1, 1) or (C, 1, 1)). None where Caffe's layers cannot hold it."""
    value = np.asarray(value, np.float32)
    if value.size == 1:
        return value.reshape(1)
    shape = list(value.shape)
    while shape and shape[0] == 1:
        shape.pop(0)
    if len(shape) == 3 and shape[1:] == [1, 1]:
        return value.reshape(-1)
    return None


class CaffeExporter(GraphExporter):
    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        net = self._build_net(graph)
        self._write(net, file_path)
        if config_path:
            from ..onnx.exporter import dump_quant_config_json
            dump_quant_config_json(graph, config_path)

    def _build_net(self, graph: BaseGraph) -> 'pb.NetParameter':
        net = pb.NetParameter()
        net.name = graph.name
        for name, var in graph.inputs.items():
            net.input.append(name)
            shp = net.input_shape.add()
            shp.dim.extend(int(d) for d in (var.shape or [1]))
        for op in graph.topological_sort():
            self._export_op(net, op)
        return net

    def _write(self, net: 'pb.NetParameter', file_path: str):
        base, ext = os.path.splitext(file_path)
        proto_path = file_path if ext == '.prototxt' else base + '.prototxt'
        model_path = base + '.caffemodel'
        with open(proto_path, 'w') as f:
            f.write(text_format.MessageToString(net))
        with open(model_path, 'wb') as f:
            f.write(net.SerializeToString())

    # ------------------------------------------------------------------ ops
    def _export_op(self, net, op: Operation):
        layer = net.layer.add()
        layer.name = op.name
        layer.bottom.extend(v.name for v in op.inputs if not v.is_parameter)
        layer.top.extend(v.name for v in op.outputs)
        params = [v for v in op.inputs if v.is_parameter and v.has_value]
        t = op.type

        if t in ('Conv', 'ConvTranspose'):
            layer.type = 'Convolution' if t == 'Conv' else 'Deconvolution'
            p = layer.convolution_param
            w = np.asarray(params[0].value)
            p.num_output = int(w.shape[0] if t == 'Conv' else w.shape[1])
            ks = op.attributes.get('kernel_shape', list(w.shape[2:]))
            p.kernel_size.append(int(ks[0]))
            strides = op.attributes.get('strides', [1, 1])
            p.stride.append(int(strides[0]))
            pads = op.attributes.get('pads', [0, 0, 0, 0])
            p.pad.append(int(pads[0]))
            dil = op.attributes.get('dilations', [1, 1])
            p.dilation.append(int(dil[0]))
            p.group = int(op.attributes.get('group', 1))
            p.bias_term = len(params) > 1
            for pv in params:
                _set_blob(layer.blobs.add(), pv.value)
            return

        if t == 'Gemm':
            layer.type = 'InnerProduct'
            p = layer.inner_product_param
            w = np.asarray(params[0].value)
            trans_b = int(op.attributes.get('transB', 0))
            if not trans_b:
                w = np.ascontiguousarray(w.T)   # caffe stores (out, in)
            p.num_output = int(w.shape[0])
            p.bias_term = len(params) > 1
            _set_blob(layer.blobs.add(), w)
            if len(params) > 1:
                _set_blob(layer.blobs.add(), params[1].value)
            return

        if t in ('MaxPool', 'AveragePool', 'GlobalMaxPool',
                 'GlobalAveragePool'):
            layer.type = 'Pooling'
            p = layer.pooling_param
            p.pool = p.MAX if 'Max' in t else p.AVE
            if t.startswith('Global'):
                p.global_pooling = True
            else:
                ks = op.attributes.get('kernel_shape', [2, 2])
                p.kernel_size = int(ks[0])
                p.stride = int(op.attributes.get('strides', [1, 1])[0])
                p.pad = int(op.attributes.get('pads', [0, 0, 0, 0])[0])
            return

        if t == 'Relu':
            layer.type = 'ReLU'
            return
        if t == 'LeakyRelu':
            layer.type = 'ReLU'
            layer.relu_param.negative_slope = float(
                op.attributes.get('alpha', 0.01))
            return
        if t == 'BatchNormalization':
            layer.type = 'BatchNorm'
            layer.batch_norm_param.eps = float(
                op.attributes.get('epsilon', 1e-5))
            gamma, beta, mean, var = (np.asarray(p.value) for p in params[:4])
            _set_blob(layer.blobs.add(), mean)
            _set_blob(layer.blobs.add(), var)
            _set_blob(layer.blobs.add(), np.asarray([1.0]))
            # gamma/beta ride in a following Scale layer
            scale = net.layer.add()
            scale.name = f'{op.name}_scale'
            scale.type = 'Scale'
            scale.bottom.append(op.outputs[0].name)
            scale.top.append(op.outputs[0].name)   # in-place, caffe idiom
            scale.scale_param.bias_term = True
            _set_blob(scale.blobs.add(), gamma)
            _set_blob(scale.blobs.add(), beta)
            return
        if t in ('Add', 'Mul') and len(params) == 1 and \
                len(layer.bottom) == 1:
            per_channel = _channel_operand(params[0].value)
            if per_channel is not None:
                # a Scale (Mul) or Bias (Add) layer, which the parser reads
                # back to the same op; the JAX package's exporter writes a
                # custom layer that no parser reads (ROADMAP.md queue 3,
                # recorded difference 40)
                if t == 'Mul':
                    layer.type = 'Scale'
                    layer.scale_param.bias_term = False
                else:
                    layer.type = 'Bias'
                _set_blob(layer.blobs.add(), per_channel)
                return
        if t in ('Add', 'Mul', 'Max') and not params:
            layer.type = 'Eltwise'
            layer.eltwise_param.operation = {
                'Mul': 0, 'Add': 1, 'Max': 2}[t]
            return
        if t == 'Concat':
            layer.type = 'Concat'
            layer.concat_param.axis = int(op.attributes.get('axis', 1))
            return
        if t == 'Softmax':
            layer.type = 'Softmax'
            layer.softmax_param.axis = int(op.attributes.get('axis', 1))
            return
        if t == 'Flatten':
            layer.type = 'Flatten'
            layer.flatten_param.axis = int(op.attributes.get('axis', 1))
            return
        if t == 'Transpose':
            layer.type = 'Permute'
            layer.permute_param.order.extend(
                int(x) for x in op.attributes.get('perm', []))
            return
        if t == 'Reshape':
            layer.type = 'Reshape'
            shape_var = next((v for v in op.inputs if v.is_parameter), None)
            if shape_var is not None and shape_var.has_value:
                layer.reshape_param.shape.dim.extend(
                    int(d) for d in np.asarray(shape_var.value).reshape(-1))
            return
        if t in ('Sigmoid', 'Tanh', 'Abs', 'Dropout'):
            layer.type = {'Sigmoid': 'Sigmoid', 'Tanh': 'TanH',
                          'Abs': 'AbsVal', 'Dropout': 'Dropout'}[t]
            return
        if t == 'Resize':
            mode = str(op.attributes.get('mode', b'nearest'))
            if 'nearest' in mode:
                # parser round-trip target: NNUpsample (PPL proto)
                layer.type = 'NNUpsample'
                scales_var = next(
                    (v for v in op.inputs[2:3] if v.is_parameter), None)
                zoom = 2
                if scales_var is not None and scales_var.has_value and \
                        np.asarray(scales_var.value).size >= 4:
                    zoom = int(np.asarray(scales_var.value).reshape(-1)[2])
                layer.nn_upsample_param.resize = zoom
            else:
                layer.type = 'Interp'
                zoom = None
                scales_var = next(
                    (v for v in op.inputs[2:3] if v.is_parameter), None)
                if scales_var is not None and scales_var.has_value and \
                        np.asarray(scales_var.value).size >= 4:
                    zoom = int(np.asarray(scales_var.value).reshape(-1)[2])
                elif len(op.inputs) > 3 and op.inputs[3].is_parameter \
                        and op.inputs[3].has_value:
                    # sizes-driven Resize: emit absolute height/width
                    # (interp_param.zoom_factor defaults to 1 — leaving
                    # it unset would silently export an identity resize)
                    sizes = np.asarray(op.inputs[3].value).reshape(-1)
                    if sizes.size >= 4:
                        layer.interp_param.height = int(sizes[2])
                        layer.interp_param.width = int(sizes[3])
                        return
                if zoom is None:
                    ppq_warning(
                        f'Caffe exporter: Resize {op.name} has neither a '
                        f'concrete scales nor sizes input; Interp '
                        f'zoom_factor defaults to 1 (identity).')
                else:
                    layer.interp_param.zoom_factor = zoom
            return
        if t == 'PRelu':
            layer.type = 'PReLU'
            slope = np.asarray(params[0].value).reshape(-1)
            _set_blob(layer.blobs.add(), slope)
            return
        if t == 'Clip':
            # bounds live positionally in inputs[1:3] (either may be an
            # absent optional), or as opset-6 attributes
            lo, hi = -3.4e38, 3.4e38
            if 'min' in op.attributes:
                lo = float(op.attributes['min'])
            if 'max' in op.attributes:
                hi = float(op.attributes['max'])
            ins = list(op.inputs)
            if len(ins) > 1 and ins[1] is not None and ins[1].has_value:
                lo = float(np.asarray(ins[1].value))
            if len(ins) > 2 and ins[2] is not None and ins[2].has_value:
                hi = float(np.asarray(ins[2].value))
            if lo == 0.0 and hi == 6.0:
                layer.type = 'ReLU6'
            else:
                layer.type = 'Clip'
                layer.clip_param.min = lo
                layer.clip_param.max = hi
            return
        if t == 'Pad':
            mode = op.attributes.get('mode', b'constant')
            mode = mode.decode() if isinstance(mode, bytes) else str(mode)
            layer.type = 'ReflectionPad' if mode == 'reflect' else 'Pad'
            pads = (np.asarray(params[0].value).reshape(-1)
                    if params else np.zeros(8, np.int64))
            if pads.size >= 8:               # NCHW onnx layout
                # caffe pad_param is SYMMETRIC per spatial axis; ONNX
                # begin/end pads that differ (or N/C pads) cannot be
                # represented — warn instead of silently dropping them
                if (int(pads[2]) != int(pads[6]) or
                        int(pads[3]) != int(pads[7]) or
                        any(int(p) for p in (pads[0], pads[1],
                                             pads[4], pads[5]))):
                    ppq_warning(
                        f'Caffe exporter: Pad {op.name} has asymmetric '
                        f'or batch/channel pads {pads.tolist()}; caffe '
                        f'pad_param is symmetric H/W only — exporting '
                        f'max(begin, end) per spatial axis.')
                layer.pad_param.pad_h = int(max(pads[2], pads[6]))
                layer.pad_param.pad_w = int(max(pads[3], pads[7]))
            layer.pad_param.mode = 1 if mode == 'reflect' else 0
            return
        if t == 'Split':
            # caffe 'Slice' == onnx Split along an axis
            layer.type = 'Slice'
            layer.slice_param.axis = int(op.attributes.get('axis', 1))
            sizes = op.attributes.get('split')
            if sizes is None and params:
                sizes = [int(s) for s in
                         np.asarray(params[0].value).reshape(-1)]
            if sizes:
                pts = np.cumsum([int(s) for s in sizes])[:-1]
                layer.slice_param.slice_point.extend(int(p) for p in pts)
            return
        if t == 'Pow':
            layer.type = 'Power'
            exp = (float(np.asarray(params[0].value).reshape(-1)[0])
                   if params else 1.0)
            layer.power_param.power = exp
            layer.power_param.scale = 1.0
            layer.power_param.shift = 0.0
            return
        if t == 'ReduceMean':
            axes = op.attributes.get('axes', [1])
            if not isinstance(axes, (list, tuple)):
                axes = [axes]
            keepdims = int(op.attributes.get('keepdims', 1))
            if len(axes) != 1 or keepdims:
                # caffe Reduce is single-axis, keepdims=0 (the reference
                # exporter asserts the same, caffe_export_utils.py:244);
                # fall through to the custom-layer path with a warning
                # rather than exporting silently-wrong semantics
                ppq_warning(
                    f'Caffe exporter: ReduceMean {op.name} with '
                    f'axes={list(axes)} keepdims={keepdims} does not map '
                    f'to caffe Reduce (single axis, keepdims=0); '
                    f'exporting as a custom layer.')
            else:
                layer.type = 'Reduce'
                layer.reduce_param.axis = int(axes[0])
                # mode stays 0: the PPL proto's ReduceOp { MEAN = 0 }
                return
        if t == 'ReduceL2':
            layer.type = 'ReduceL2'
            return
        if t in ('HardSwish', 'HardSigmoid'):
            layer.type = 'HSwish' if t == 'HardSwish' else 'HSigmoid'
            return
        if t == 'InstanceNormalization':
            layer.type = 'InstanceNorm'
            scale = np.asarray(params[0].value) if params else None
            layer.instance_norm_param.eps = float(
                op.attributes.get('epsilon', 1e-5))
            if scale is not None:
                layer.instance_norm_param.num_features = int(scale.size)
                layer.instance_norm_param.affine = True
                _set_blob(layer.blobs.add(), scale)
                if len(params) > 1:
                    _set_blob(layer.blobs.add(), params[1].value)
            return
        if t == 'Tile':
            reps = (np.asarray(params[0].value).reshape(-1)
                    if params else np.ones(1, np.int64))
            hot = [i for i, r in enumerate(reps) if int(r) != 1] or [0]
            if len(hot) > 1:
                # caffe Tile repeats exactly one axis; multi-axis repeats
                # fall through to the custom-layer path with a warning
                ppq_warning(
                    f'Caffe exporter: Tile {op.name} repeats multiple '
                    f'axes {reps.tolist()}; caffe tile_param is single '
                    f'axis — exporting as a custom layer.')
            else:
                layer.type = 'Tile'
                layer.tile_param.axis = int(hot[0])
                layer.tile_param.tiles = int(reps[hot[0]])
                return
        if t == 'ChannelShuffle':
            layer.type = 'ChannelShuffle'
            layer.channel_shuffle_param.group = int(
                op.attributes.get('group', 1))
            return
        if t in ('SpaceToDepth', 'DepthToSpace'):
            block = int(op.attributes.get('blocksize', 1))
            if t == 'SpaceToDepth':
                layer.type = 'SubpixelDown'
                layer.subpixel_down_param.downsample = block
            else:
                layer.type = 'SubpixelUp'
                layer.subpixel_up_param.upsample = block
            return
        if t == 'ArgMax':
            layer.type = 'ArgMax'
            layer.argmax_param.axis = int(op.attributes.get('axis', 1))
            layer.argmax_param.top_k = 1
            return
        if t in ('MatMul', 'Sub', 'Div') and not params:
            layer.type = t
            return
        if t == 'Mul' and params:
            # Mul with a parameter gate/weight — caffe Scale layer
            layer.type = 'Scale'
            layer.scale_param.axis = 1
            layer.scale_param.bias_term = False
            _set_blob(layer.blobs.add(),
                      np.asarray(params[0].value).reshape(-1))
            return

        ppq_warning(f'Caffe exporter: op type {t!r} has no native caffe '
                    f'layer; exported with type={t!r} (custom layer).')
        layer.type = t
        for pv in params:
            _set_blob(layer.blobs.add(), pv.value)


# ===================================================== quantized variants ===

def _range_of(cfg):
    """(range_min, range_max) arrays from a TQC (reference
    caffe_exporter.py convert_value usage)."""
    scale = np.asarray(cfg.scale, np.float64).reshape(-1)
    offset = np.asarray(cfg.offset, np.float64).reshape(-1)
    return (scale * (cfg.quant_min - offset),
            scale * (cfg.quant_max - offset))


class PPLDSPCaffeExporter(CaffeExporter):
    """PPL-DSP flavor (reference caffe_exporter.py:248 PPLDSPCaffeExporter):
    quantization ranges are embedded directly in the prototxt — per-layer
    bottom/top `quantize_param` entries plus filter ranges on
    Convolution/InnerProduct — no JSON sidecar."""

    per_channel_filter = False

    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        net = self._build_net(graph)
        for layer in net.layer:
            op = graph.operations.get(layer.name)
            if op is None or not isinstance(op, QuantableOperation):
                continue
            # bottom/top activation ranges
            for var, cfg in op.config_pairs():
                root = cfg.dominated_by
                if var.is_parameter or not root.has_scale:
                    continue
                if root.num_of_bits > 8:
                    continue
                lo, hi = _range_of(root)
                kind = ('bottom' if var.name in {v.name for v in op.inputs}
                        else 'top')
                layer.quantize_param.add(type=kind,
                                         range_min=float(lo.min()),
                                         range_max=float(hi.max()))
            # filter ranges
            if layer.type in ('Convolution', 'Deconvolution',
                              'InnerProduct'):
                holder = (layer.convolution_param
                          if layer.type != 'InnerProduct'
                          else layer.inner_product_param)
                for var, cfg in op.config_pairs():
                    root = cfg.dominated_by
                    if not var.is_parameter or not root.has_scale:
                        continue
                    if root.num_of_bits > 8:
                        continue          # skip bias configs
                    lo, hi = _range_of(root)
                    if self.per_channel_filter and lo.size > 1:
                        for lo_c, hi_c in zip(lo, hi):
                            p = holder.perchannel_quantize_param.add()
                            p.type = 'filter'
                            p.range_min = float(lo_c)
                            p.range_max = float(hi_c)
                    else:
                        p = holder.quantize_param
                        p.type = 'filter'
                        p.range_min = float(lo.min())
                        p.range_max = float(hi.max())
                    break
        self._write(net, file_path)


class PPLDSPTICaffeExporter(PPLDSPCaffeExporter):
    """DSP-TI flavor (reference caffe_exporter.py:403): identical layout but
    computing-op filters carry PER-CHANNEL range entries."""

    per_channel_filter = True


class SNPECaffeExporter(CaffeExporter):
    """SNPE flavor (reference caffe_exporter.py:179): caffe model files plus
    an activation-encodings JSON in SNPE's layout."""

    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        net = self._build_net(graph)
        self._write(net, file_path)
        if not config_path:
            base, _ = os.path.splitext(file_path)
            config_path = base + '_encodings.json'
        acts = {}
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            for var, cfg in op.config_pairs():
                root = cfg.dominated_by
                if var.is_parameter or not root.has_scale:
                    continue
                if root.state in (QuantizationStates.FP32,):
                    continue
                lo, hi = _range_of(root)
                acts[var.name] = [{
                    'bitwidth': int(root.num_of_bits),
                    'min': float(lo.min()), 'max': float(hi.max()),
                    'scale': float(np.asarray(root.scale).reshape(-1)[0]),
                    'offset': int(np.asarray(
                        root.offset, np.float64).reshape(-1)[0]),
                }]
        with open(config_path, 'w') as f:
            json.dump({'activation_encodings': acts,
                       'param_encodings': {}}, f, indent=2)
