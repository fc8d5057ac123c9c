"""Caffe frontend: prototxt (+ optional caffemodel weights) → BaseGraph
(redesign of ppq/parser/caffe_parser.py:71 + caffe/ subdir).

Layer mapping (caffe → ONNX-semantic IR ops the executor understands):

  Convolution→Conv, Deconvolution→ConvTranspose, InnerProduct→Gemm,
  Pooling→Max/AveragePool/Global*, ReLU→Relu/LeakyRelu, Sigmoid, TanH→Tanh,
  BatchNorm→BatchNormalization (+folds trailing Scale), Scale→Mul(+Add),
  Eltwise→Add/Mul/Max, Concat, Softmax, Flatten, Reshape, Permute→Transpose,
  Dropout, Power, AbsVal→Abs, Interp/Upsample→Resize, Slice→Split.

Port of ppq_tpu/frontends/caffe/parser.py. The port's op table runs the
ResNet family's ops only (executor/ops/default.py); a net with a layer
whose op is not in the table raises NotImplementedError when it is parsed
(ROADMAP.md queue 1, item 3 ports the rest of the ops).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from google.protobuf import text_format

from ...core import ppq_warning
from ...executor.ops.default import DEFAULT_BACKEND_TABLE
from ...ir import BaseGraph, GraphBuilder, Operation, Variable
from . import caffe_pb2 as pb


def _blob_to_array(blob: 'pb.BlobProto') -> np.ndarray:
    data = np.asarray(blob.data, np.float32)
    if blob.HasField('shape') and len(blob.shape.dim):
        return data.reshape([int(d) for d in blob.shape.dim])
    dims = [blob.num, blob.channels, blob.height, blob.width]
    dims = [d for d in dims if d > 0]
    return data.reshape(dims) if dims else data


class CaffeParser(GraphBuilder):
    def build(self, prototxt_path: str,
              caffemodel_path: Optional[str] = None) -> BaseGraph:
        net = pb.NetParameter()
        with open(prototxt_path) as f:
            text_format.Merge(f.read(), net)
        weights: Dict[str, List[np.ndarray]] = {}
        if caffemodel_path is not None:
            wnet = pb.NetParameter()
            with open(caffemodel_path, 'rb') as f:
                wnet.ParseFromString(f.read())
            for layer in wnet.layer:
                weights[layer.name] = [_blob_to_array(b) for b in layer.blobs]
        return self._build_graph(net, weights)

    # ------------------------------------------------------------------ build
    def _build_graph(self, net, weights) -> BaseGraph:
        g = BaseGraph(net.name or 'caffe_net')
        blobs: Dict[str, Variable] = {}

        def blob(name: str) -> Variable:
            if name not in blobs:
                blobs[name] = g.create_variable(name)
            return blobs[name]

        # net-level inputs
        for i, name in enumerate(net.input):
            var = blob(name)
            if i < len(net.input_shape):
                var.shape = [int(d) for d in net.input_shape[i].dim]
            elif len(net.input_dim) >= 4 * (i + 1):
                var.shape = [int(d) for d in net.input_dim[4 * i: 4 * i + 4]]
            g.mark_as_input(var)

        consumed = set()
        produced = set()

        for layer in net.layer:
            w = weights.get(layer.name, [_blob_to_array(b)
                                         for b in layer.blobs])
            self._convert_layer(g, layer, w, blobs, blob)
            consumed.update(layer.bottom)
            produced.update(layer.top)

        # graph outputs: variables produced by some layer that no layer
        # consumes (checked on the de-inplaced variables, not blob names —
        # a final in-place ReLU renames its top)
        for var in list(blobs.values()):
            if var.source_op is not None and not var.dest_ops and \
                    not var.is_parameter:
                g.mark_as_output(var)
        del consumed, produced
        missing = sorted({op.type for op in g.operations.values()}
                         - set(DEFAULT_BACKEND_TABLE))
        if missing:
            raise NotImplementedError(
                f'Caffe net {g.name!r} needs ops the port does not run yet: '
                f'{missing} (ROADMAP.md queue 1, item 3)')
        return g

    def _param(self, g, name, value):
        return g.create_variable(name, value=np.asarray(value, np.float32),
                                 is_parameter=True)

    def _convert_layer(self, g: BaseGraph, layer, w, blobs, blob):
        t = layer.type
        name = layer.name
        bottoms = [blob(b) for b in layer.bottom]

        def make_tops(n_out: int) -> List[Variable]:
            """De-inplace top handling (reference onnx_parser.py:59): a layer
            writing its own bottom gets a fresh variable, and the blob table
            repoints so later consumers read the newest version."""
            outs = []
            for i in range(n_out):
                tn = layer.top[i]
                if i < len(layer.bottom) and tn == layer.bottom[i]:
                    var = g.create_variable(f'{tn}__{name}')
                else:
                    var = blob(tn)
                outs.append(var)
                blobs[tn] = var
            return outs

        if t == 'Input':
            for i, tn in enumerate(layer.top):
                var = blob(tn)
                if layer.HasField('input_param') and \
                        i < len(layer.input_param.shape):
                    var.shape = [int(d)
                                 for d in layer.input_param.shape[i].dim]
                g.mark_as_input(var)
            return

        if t == 'Convolution' or t == 'Deconvolution':
            p = layer.convolution_param
            kh = int(p.kernel_h or (p.kernel_size[0] if p.kernel_size else 1))
            kw = int(p.kernel_w or (p.kernel_size[-1] if p.kernel_size
                                    else kh))
            sh = int(p.stride_h or (p.stride[0] if p.stride else 1))
            sw = int(p.stride_w or (p.stride[-1] if p.stride else sh))
            ph = int(p.pad_h or (p.pad[0] if p.pad else 0))
            pw = int(p.pad_w or (p.pad[-1] if p.pad else ph))
            dil = int(p.dilation[0]) if p.dilation else 1
            inputs = [bottoms[0]]
            if w:
                inputs.append(self._param(g, f'{name}_w', w[0]))
            if p.bias_term and len(w) > 1:
                inputs.append(self._param(g, f'{name}_b', w[1]))
            op_type = 'Conv' if t == 'Convolution' else 'ConvTranspose'
            g.create_operation(
                op_type, name=name,
                attributes={'kernel_shape': [kh, kw], 'strides': [sh, sw],
                            'pads': [ph, pw, ph, pw],
                            'dilations': [dil, dil],
                            'group': int(p.group)},
                inputs=inputs, outputs=make_tops(1))
            return

        if t == 'InnerProduct':
            p = layer.inner_product_param
            inputs = [bottoms[0]]
            if w:
                wt = w[0]
                # caffe stores (out, in); Gemm transB=1 keeps it as-is
                inputs.append(self._param(g, f'{name}_w', wt))
            if p.bias_term and len(w) > 1:
                inputs.append(self._param(g, f'{name}_b', w[1]))
            g.create_operation(
                'Gemm', name=name,
                attributes={'alpha': 1.0, 'beta': 1.0, 'transA': 0,
                            'transB': 1},
                inputs=inputs, outputs=make_tops(1))
            return

        if t == 'Pooling':
            p = layer.pooling_param
            if p.global_pooling:
                op_type = ('GlobalMaxPool' if p.pool == p.MAX
                           else 'GlobalAveragePool')
                g.create_operation(op_type, name=name, inputs=[bottoms[0]],
                                   outputs=make_tops(1))
                return
            k = int(p.kernel_h or p.kernel_size)
            kw_ = int(p.kernel_w or k)
            s = int(p.stride_h or p.stride)
            sw_ = int(p.stride_w or s)
            pad = int(p.pad_h or p.pad)
            pw_ = int(p.pad_w or pad)
            op_type = 'MaxPool' if p.pool == p.MAX else 'AveragePool'
            attrs = {'kernel_shape': [k, kw_], 'strides': [s, sw_],
                     'pads': [pad, pw_, pad, pw_],
                     'ceil_mode': 1 if p.ceil_mode else 0}
            if op_type == 'AveragePool':
                attrs['count_include_pad'] = 1
            g.create_operation(op_type, name=name, inputs=[bottoms[0]],
                               outputs=make_tops(1), attributes=attrs)
            return

        if t == 'ReLU':
            slope = float(layer.relu_param.negative_slope)
            if slope != 0.0:
                g.create_operation('LeakyRelu', name=name,
                                   attributes={'alpha': slope},
                                   inputs=[bottoms[0]], outputs=make_tops(1))
            else:
                g.create_operation('Relu', name=name, inputs=[bottoms[0]],
                                   outputs=make_tops(1))
            return

        if t == 'BatchNorm':
            eps = float(layer.batch_norm_param.eps) \
                if layer.HasField('batch_norm_param') else 1e-5
            mean, var_, factor = (w + [np.asarray([1.0])] * 3)[:3]
            scale = 1.0 / factor.reshape(-1)[0] if factor.size else 1.0
            c = mean.size
            g.create_operation(
                'BatchNormalization', name=name,
                attributes={'epsilon': eps},
                inputs=[bottoms[0],
                        self._param(g, f'{name}_gamma', np.ones(c)),
                        self._param(g, f'{name}_beta', np.zeros(c)),
                        self._param(g, f'{name}_mean', mean * scale),
                        self._param(g, f'{name}_var', var_ * scale)],
                outputs=make_tops(1))
            return

        if t == 'Scale':
            p = layer.scale_param
            gamma = w[0] if w else np.ones(1)
            c = gamma.size
            sc = self._param(g, f'{name}_scale',
                             gamma.reshape(1, c, 1, 1) if c > 1 else gamma)
            mul_out = make_tops(1)[0]
            if p.bias_term and len(w) > 1:
                inter = g.create_variable(f'{name}_mul_out')
                g.create_operation('Mul', name=f'{name}_mul',
                                   inputs=[bottoms[0], sc], outputs=[inter])
                beta = w[1]
                bv = self._param(g, f'{name}_bias',
                                 beta.reshape(1, c, 1, 1) if c > 1 else beta)
                g.create_operation('Add', name=name,
                                   inputs=[inter, bv], outputs=[mul_out])
            else:
                g.create_operation('Mul', name=name,
                                   inputs=[bottoms[0], sc],
                                   outputs=[mul_out])
            return

        if t == 'Eltwise':
            p = layer.eltwise_param
            op_type = {0: 'Mul', 1: 'Add', 2: 'Max'}[int(p.operation)]
            g.create_operation(op_type, name=name, inputs=bottoms,
                               outputs=make_tops(1))
            return

        if t == 'Concat':
            g.create_operation('Concat', name=name,
                               attributes={'axis': int(
                                   layer.concat_param.axis)},
                               inputs=bottoms, outputs=make_tops(1))
            return

        if t == 'Softmax':
            g.create_operation('Softmax', name=name,
                               attributes={'axis': int(
                                   layer.softmax_param.axis)},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'Flatten':
            g.create_operation('Flatten', name=name,
                               attributes={'axis': int(
                                   layer.flatten_param.axis)},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'Reshape':
            shape = [int(d) for d in layer.reshape_param.shape.dim]
            shp = g.create_variable(f'{name}_shape',
                                    value=np.asarray(shape, np.int64),
                                    is_parameter=True)
            g.create_operation('Reshape', name=name,
                               inputs=[bottoms[0], shp],
                               outputs=make_tops(1))
            return

        if t == 'Permute':
            g.create_operation('Transpose', name=name,
                               attributes={'perm': [int(o) for o in
                                                    layer.permute_param.order]},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t in ('Sigmoid', 'TanH', 'AbsVal', 'Dropout'):
            op_type = {'Sigmoid': 'Sigmoid', 'TanH': 'Tanh',
                       'AbsVal': 'Abs', 'Dropout': 'Dropout'}[t]
            g.create_operation(op_type, name=name, inputs=[bottoms[0]],
                               outputs=make_tops(1))
            return

        if t == 'Power':
            p = layer.power_param
            x = bottoms[0]
            cur = x
            if p.scale != 1.0:
                inter = g.create_variable(f'{name}_scaled')
                g.create_operation('Mul', name=f'{name}_scale',
                                   inputs=[cur, self._param(
                                       g, f'{name}_s', np.asarray(p.scale))],
                                   outputs=[inter])
                cur = inter
            if p.shift != 0.0:
                inter = g.create_variable(f'{name}_shifted')
                g.create_operation('Add', name=f'{name}_shift',
                                   inputs=[cur, self._param(
                                       g, f'{name}_t', np.asarray(p.shift))],
                                   outputs=[inter])
                cur = inter
            out = make_tops(1)[0]
            g.create_operation('Pow', name=name,
                               inputs=[cur, self._param(
                                   g, f'{name}_p', np.asarray(p.power))],
                               outputs=[out])
            return

        if t in ('Interp', 'Upsample'):
            roi = self._param(g, f'{name}_roi', np.zeros(0, np.float32))
            mode = 'linear' if t == 'Interp' else 'nearest'
            attrs = {'mode': mode,
                     'coordinate_transformation_mode':
                         'align_corners' if t == 'Interp'
                         else 'asymmetric'}
            if t == 'Interp' and (int(layer.interp_param.height) or
                                  int(layer.interp_param.width)):
                # absolute-size Interp (sizes-driven Resize round-trip):
                # emit a sizes input (empty scales placeholder)
                shp = bottoms[0].shape or [1, 1, 1, 1]
                sizes = self._param(
                    g, f'{name}_sizes',
                    np.asarray([int(shp[0]), int(shp[1]),
                                int(layer.interp_param.height),
                                int(layer.interp_param.width)], np.int64))
                scales = self._param(g, f'{name}_scales',
                                     np.zeros(0, np.float32))
                g.create_operation(
                    'Resize', name=name, attributes=attrs,
                    inputs=[bottoms[0], roi, scales, sizes],
                    outputs=make_tops(1))
                return
            if t == 'Interp':
                zoom = int(layer.interp_param.zoom_factor)
            else:
                zoom = int(layer.upsample_param.scale)
            scales = self._param(g, f'{name}_scales',
                                 np.asarray([1, 1, zoom, zoom], np.float32))
            g.create_operation(
                'Resize', name=name, attributes=attrs,
                inputs=[bottoms[0], roi, scales], outputs=make_tops(1))
            return

        if t == 'Slice':
            p = layer.slice_param
            n_out = len(layer.top)
            attrs = {'axis': int(p.axis)}
            inputs = [bottoms[0]]
            if p.slice_point:
                sizes = []
                prev = 0
                for sp in p.slice_point:
                    sizes.append(int(sp) - prev)
                    prev = int(sp)
                # the last chunk's extent isn't in the proto; -1 resolves
                # against the concrete axis dim at execution
                # (Split_forward 'split' attribute)
                sizes.append(-1)
                attrs['split'] = sizes
            g.create_operation('Split', name=name, attributes=attrs,
                               inputs=inputs, outputs=make_tops(n_out))
            return

        if t == 'PReLU':
            slope = (w[0] if w else np.full((1,), 0.25, np.float32))
            slope = np.asarray(slope, np.float32).reshape(1, -1, 1, 1)
            g.create_operation('PRelu', name=name,
                               inputs=[bottoms[0],
                                       self._param(g, f'{name}_slope',
                                                   slope)],
                               outputs=make_tops(1))
            return

        if t == 'ReLU6':
            g.create_operation(
                'Clip', name=name,
                inputs=[bottoms[0],
                        self._param(g, f'{name}_min',
                                    np.asarray(0.0, np.float32)),
                        self._param(g, f'{name}_max',
                                    np.asarray(6.0, np.float32))],
                outputs=make_tops(1))
            return

        if t == 'Clip':
            p = layer.clip_param
            g.create_operation(
                'Clip', name=name,
                inputs=[bottoms[0],
                        self._param(g, f'{name}_min',
                                    np.asarray(p.min, np.float32)),
                        self._param(g, f'{name}_max',
                                    np.asarray(p.max, np.float32))],
                outputs=make_tops(1))
            return

        if t in ('Add', 'Sub', 'Mul', 'Div', 'Max'):
            g.create_operation(t, name=name, inputs=bottoms[:2],
                               outputs=make_tops(1))
            return

        if t in ('HSwish', 'HSigmoid'):
            op_type = 'HardSwish' if t == 'HSwish' else 'HardSigmoid'
            attrs = ({'alpha': 1.0 / 6.0, 'beta': 0.5}
                     if op_type == 'HardSigmoid' else {})
            g.create_operation(op_type, name=name, attributes=attrs,
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'Tile':
            p = layer.tile_param
            axis, tiles = int(p.axis), int(p.tiles)
            # ONNX Tile takes a full repeats vector; rank from bottom shape
            rank = len(bottoms[0].shape) if bottoms[0].shape else 4
            reps = np.ones(rank, np.int64)
            reps[axis] = tiles
            g.create_operation('Tile', name=name,
                               inputs=[bottoms[0],
                                       self._param(g, f'{name}_reps', reps)],
                               outputs=make_tops(1))
            return

        if t == 'ChannelShuffle':
            p = layer.channel_shuffle_param
            g.create_operation('ChannelShuffle', name=name,
                               attributes={'group': int(p.group)},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'InstanceNorm':
            p = layer.instance_norm_param
            c = int(p.num_features) if p.num_features else \
                (bottoms[0].shape[1] if bottoms[0].shape else 1)
            scale = (w[0] if (p.affine and w) else np.ones(c, np.float32))
            bias = (w[1] if (p.affine and len(w) > 1)
                    else np.zeros(c, np.float32))
            g.create_operation(
                'InstanceNormalization', name=name,
                attributes={'epsilon': float(p.eps)},
                inputs=[bottoms[0],
                        self._param(g, f'{name}_scale',
                                    np.asarray(scale, np.float32).reshape(-1)),
                        self._param(g, f'{name}_bias',
                                    np.asarray(bias, np.float32).reshape(-1))],
                outputs=make_tops(1))
            return

        if t == 'ArgMax':
            p = layer.argmax_param
            if p.out_max_val or int(p.top_k) != 1:
                ppq_warning(f'ArgMax {name}: out_max_val/top_k>1 not '
                            f'supported, emitting plain ArgMax')
            axis = int(p.axis) if p.HasField('axis') else 1
            g.create_operation('ArgMax', name=name,
                               attributes={'axis': axis, 'keepdims': 1},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'MatMul':
            g.create_operation('MatMul', name=name, inputs=bottoms[:2],
                               outputs=make_tops(1))
            return

        if t in ('Reduce', 'ReduceL2'):
            if t == 'ReduceL2':
                op_type, axis = 'ReduceL2', 1
            else:
                # PPL proto dialect: ReduceOp { MEAN = 0 } — mode 0 IS
                # mean (reference caffe.proto:2013)
                op_type = 'ReduceMean'
                axis = int(layer.reduce_param.axis)
            g.create_operation(op_type, name=name,
                               attributes={'axes': [axis], 'keepdims': 0},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'NNUpsample':
            zoom = int(layer.nn_upsample_param.resize)
            g.create_operation(
                'Resize', name=name,
                attributes={'mode': 'nearest',
                            'coordinate_transformation_mode': 'asymmetric'},
                inputs=[bottoms[0],
                        self._param(g, f'{name}_roi',
                                    np.zeros(0, np.float32)),
                        self._param(g, f'{name}_scales',
                                    np.asarray([1, 1, zoom, zoom],
                                               np.float32))],
                outputs=make_tops(1))
            return

        if t in ('SubpixelDown', 'SubpixelUp'):
            if t == 'SubpixelDown':
                op_type = 'SpaceToDepth'
                block = int(layer.subpixel_down_param.downsample)
            else:
                op_type = 'DepthToSpace'
                block = int(layer.subpixel_up_param.upsample)
            g.create_operation(op_type, name=name,
                               attributes={'blocksize': block},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'ReflectionPad' or t == 'Pad':
            p = layer.pad_param
            pad = int(p.pad)
            ph = int(p.pad_h) or pad
            pw = int(p.pad_w) or pad
            pads = np.asarray([0, 0, ph, pw, 0, 0, ph, pw], np.int64)
            mode = 'reflect' if (t == 'ReflectionPad' or
                                 int(p.mode) == 1) else 'constant'
            g.create_operation('Pad', name=name,
                               attributes={'mode': mode},
                               inputs=[bottoms[0],
                                       self._param(g, f'{name}_pads', pads)],
                               outputs=make_tops(1))
            return

        if t == 'Parameter':
            p = layer.parameter_param
            dims = [int(v) for v in (p.batch, p.channel, p.height, p.width)
                    if int(v) > 0] or [int(p.m), int(p.n)]
            value = (w[0] if w else np.zeros(dims, np.float32))
            out = make_tops(1)[0]
            out.value = np.asarray(value, np.float32)
            out.is_parameter = True
            return

        if t == 'Transpose':
            perm = [int(v) for v in layer.permute_param.order]
            g.create_operation('Transpose', name=name,
                               attributes={'perm': perm},
                               inputs=[bottoms[0]], outputs=make_tops(1))
            return

        if t == 'BN':
            # ppl-caffe BN layer: y = scale * (x - mean)/sqrt(var + eps) +
            # shift, blobs = [scale, shift, mean, var]
            c = w[0].size if w else 1
            scale = w[0].reshape(-1) if w else np.ones(c, np.float32)
            shift = (w[1].reshape(-1) if len(w) > 1
                     else np.zeros(c, np.float32))
            mean = (w[2].reshape(-1) if len(w) > 2
                    else np.zeros(c, np.float32))
            var = (w[3].reshape(-1) if len(w) > 3
                   else np.ones(c, np.float32))
            g.create_operation(
                'BatchNormalization', name=name,
                attributes={'epsilon': 1e-5},
                inputs=[bottoms[0],
                        self._param(g, f'{name}_scale', scale),
                        self._param(g, f'{name}_shift', shift),
                        self._param(g, f'{name}_mean', mean),
                        self._param(g, f'{name}_var', var)],
                outputs=make_tops(1))
            return

        ppq_warning(f'Caffe layer type {t!r} ({name}) unsupported — '
                    f'inserted as opaque op.')
        g.create_operation(t, name=name, inputs=bottoms,
                           outputs=make_tops(max(1, len(layer.top))))

def load_caffe_graph(prototxt_path: str,
                     caffemodel_path: Optional[str] = None) -> BaseGraph:
    """(reference api: load_caffe_graph, ppq/api/interface.py)"""
    return CaffeParser().build(prototxt_path, caffemodel_path)
