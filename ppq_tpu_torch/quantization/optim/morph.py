"""Graph-morphing passes (redesign of ppq/quantization/optim/morph.py).

HorizontalLayerSplitPass: split a conv/gemm with extreme weight range into
two parallel halves summed back together (reference morph.py:52) — each half
quantizes with a smaller range.
GRUSplitPass / NCNNFormatGemmPass / NXPResizeModeChangePass: backend morphs.

Port of ppq_tpu/quantization/optim/morph.py, over the port's IR rewrites
(ir/morph.py).
"""

from __future__ import annotations

import numpy as np

from ...core import ppq_info, ppq_warning
from ...ir import BaseGraph, Operation
from .base import QuantizationOptimizationPass


class HorizontalLayerSplitPass(QuantizationOptimizationPass):
    """(reference optim/morph.py:52)"""

    def __init__(self, value_threshold: float = 2.0,
                 including_conv: bool = True, including_gemm: bool = True):
        super().__init__('Horizontal Layer Split Pass')
        self.value_threshold = value_threshold
        self.including_conv = including_conv
        self.including_gemm = including_gemm

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        n_split = 0
        for op in list(graph.operations.values()):
            if op.type == 'Conv' and not self.including_conv:
                continue
            if op.type == 'Gemm' and not self.including_gemm:
                continue
            if op.type not in {'Conv', 'Gemm'}:
                continue
            if len(op.inputs) < 2 or not op.inputs[1].is_parameter:
                continue
            w = np.asarray(op.inputs[1].value)
            if float(np.abs(w).max()) < self.value_threshold:
                continue
            self._split(graph, op)
            n_split += 1
        if n_split:
            ppq_info(f'Horizontally split {n_split} layers.')

    def _split(self, graph: BaseGraph, op: Operation):
        """value-split: w = w_hi + w_lo with |w_hi|,|w_lo| ≤ |w|/2; the op is
        duplicated and the two halves Add-ed (function-preserving)."""
        w_var = op.inputs[1]
        w = np.asarray(w_var.value, np.float32)
        half = w * 0.5
        # clone op
        clone_name = f'{op.name}_split'
        w2 = graph.create_variable(f'{w_var.name}_split', value=half.copy(),
                                   is_parameter=True)
        inputs2 = [op.inputs[0], w2]
        if len(op.inputs) > 2:
            b = np.asarray(op.inputs[2].value, np.float32) * 0.5
            op.inputs[2].value = b.copy()
            b2 = graph.create_variable(f'{op.inputs[2].name}_split',
                                       value=b.copy(), is_parameter=True)
            inputs2.append(b2)
        out2 = graph.create_variable(f'{op.outputs[0].name}_split')
        clone = graph.create_operation(op.type, name=clone_name,
                                       attributes=dict(op.attributes),
                                       inputs=inputs2, outputs=[out2],
                                       platform=op.platform)
        w_var.value = half
        # rewire: old_out consumers read Add(old_out, out2)
        old_out = op.outputs[0]
        add_out = graph.create_variable(f'{old_out.name}_sum')
        old_dests = [d for d in old_out.dest_ops]
        add = graph.create_operation('Add', name=f'{op.name}_sum',
                                     inputs=[old_out, out2],
                                     outputs=[add_out],
                                     platform=op.platform)
        for dest in old_dests:
            for i, v in enumerate(dest.inputs):
                if v is old_out:
                    dest.inputs[i] = add_out
            add_out.dest_ops.append(dest)
        old_out.dest_ops[:] = [add]
        if old_out.name in graph.outputs:
            del graph.outputs[old_out.name]
            graph.mark_as_output(add_out)


class GRUSplitPass(QuantizationOptimizationPass):
    """Decompose GRU into gate Gemms (reference optim/morph.py:219) so
    backends without native GRU can run/quantize it. Delegates to the IR
    decomposer."""

    def __init__(self):
        super().__init__('GRU Split Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        try:
            from ...ir.morph import decompose_gru
        except ImportError:
            ppq_warning('decompose_gru not available; GRU ops left intact '
                        '(the executor runs them natively).')
            return
        decompose_gru(graph)


class NCNNFormatGemmPass(QuantizationOptimizationPass):
    """Force Gemm attributes to ncnn's expected transB=1 layout
    (reference optim/morph.py:29)."""

    def __init__(self):
        super().__init__('NCNN Format Gemm Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in graph.operations.values():
            if op.type != 'Gemm':
                continue
            if int(op.attributes.get('transB', 0)) == 0 and \
                    len(op.inputs) > 1 and op.inputs[1].is_parameter:
                w = np.asarray(op.inputs[1].value)
                op.inputs[1].value = np.ascontiguousarray(w.T)
                op.attributes['transB'] = 1


class NXPResizeModeChangePass(QuantizationOptimizationPass):
    """NXP only supports nearest+asymmetric resize
    (reference optim/morph.py:15)."""

    def __init__(self):
        super().__init__('NXP Resize Mode Change Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in graph.operations.values():
            if op.type == 'Resize':
                op.attributes['mode'] = 'nearest'
                op.attributes['coordinate_transformation_mode'] = 'asymmetric'


class StemSpaceToDepthPass(QuantizationOptimizationPass):
    """TPU deploy optimization: rewrite tiny-C_in stride-2 stem convs into
    space-to-depth packing + stride-1 conv (ir/morph.py:stem_space_to_depth).
    Exact in fp32; quantization configs untouched. No reference counterpart
    — a TPU-first addition (MXU lane utilization, MLPerf ResNet practice).
    Run AFTER calibration (it permutes the conv input, so per-tensor
    activation observers see identical value sets either way)."""

    def __init__(self, max_in_channels: int = 4):
        super().__init__('Stem SpaceToDepth Pass')
        self.max_in_channels = max_in_channels

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        from ...ir.morph import stem_space_to_depth
        n = stem_space_to_depth(graph, self.max_in_channels)
        if n:
            ppq_info(f'StemSpaceToDepthPass: rewrote {n} stem conv(s)')
