"""Vendor-quirk passes
(redesign of ppq/quantization/optim/refine.py:630/644 NXP passes,
calibration.py:216 DSP recalibration, morph.py:202 MetaxGemmSplit,
legacy.py:329 PPLCudaAddConvReluMerge).

Port of ppq_tpu/quantization/optim/vendor.py.
"""

from __future__ import annotations

import numpy as np

from ...core import QuantizationStates, RoundingPolicy, ppq_info
from ...ir import BaseGraph, QuantableOperation
from .base import QuantizationOptimizationPass
from .calibration import RuntimeCalibrationPass


class NxpInputRoundingRefinePass(QuantizationOptimizationPass):
    """NXP rounds network inputs half-up instead of half-even
    (reference refine.py:630)."""

    def __init__(self):
        super().__init__('NXP Input Rounding Refine Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            for var, cfg in zip(op.inputs, op.config.input_quantization_config):
                if var.name in graph.inputs:
                    cfg.rounding = RoundingPolicy.ROUND_HALF_UP


class NxpQuantizeFusionPass(QuantizationOptimizationPass):
    """NXP only fuses Relu/Clip directly after computing ops; passive-op
    fusion is disabled (reference refine.py:644)."""

    def __init__(self):
        super().__init__('NXP Quantization Fusion Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        from .refine import QuantizeFusionPass
        QuantizeFusionPass(activation_type={'Relu', 'Clip'},
                           fuse_passive_op=False).optimize(
            graph, dataloader=dataloader, executor=executor, **kwargs)


class PPLDSPTIReCalibrationPass(RuntimeCalibrationPass):
    """DSP-TI recalibration: a second calibration round restricted to ops
    feeding concat/eltwise joins, with per-tensor asymmetric observers
    (reference calibration.py:216)."""

    def __init__(self, calib_steps: int = 16):
        super().__init__(method='percentile', override=True,
                         calib_steps=calib_steps)
        self.name = 'PPL DSP TI Re-Calibration Pass'

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        # reset join-feeding output TQCs to INITIAL so they recalibrate
        joins = {'Concat', 'Add', 'Sub', 'Sum', 'Max'}
        n_reset = 0
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            for out_var, cfg in zip(op.outputs,
                                    op.config.output_quantization_config):
                if any(d.type in joins for d in out_var.dest_ops) and \
                        cfg.is_root and \
                        cfg.state == QuantizationStates.ACTIVATED:
                    cfg.state = QuantizationStates.INITIAL
                    n_reset += 1
        if n_reset == 0:
            return
        super().optimize(graph, dataloader=dataloader, executor=executor,
                         collate_fn=collate_fn, **kwargs)
        ppq_info(f'DSP-TI recalibrated {n_reset} join tensors.')


class MetaxGemmSplitPass(QuantizationOptimizationPass):
    """Metax backend requires Gemm decomposed into MatMul + Add
    (reference morph.py:202)."""

    def __init__(self):
        super().__init__('Metax Gemm Split Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        from ...ir import decompose_gemm
        decompose_gemm(graph)


class PPLCudaAddConvReluMerge(QuantizationOptimizationPass):
    """Legacy fusion (reference legacy.py:329): Conv→Add→Relu residual tails
    share one quant site on fused backends — the Add inputs and Conv output
    overlap with the Relu output config."""

    def __init__(self):
        super().__init__('Add-Conv-Relu Merge Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for add in [op for op in graph.operations.values()
                    if op.type == 'Add' and isinstance(op, QuantableOperation)]:
            outs = add.outputs[0].dest_ops
            if len(outs) != 1 or outs[0].type != 'Relu':
                continue
            relu = outs[0]
            if not isinstance(relu, QuantableOperation):
                continue
            feeds_conv = any(v.source_op is not None and
                             v.source_op.type == 'Conv'
                             for v in add.inputs)
            if not feeds_conv:
                continue
            relu_out = relu.config.output_quantization_config[0]
            add.config.output_quantization_config[0].dominated_by = relu_out
            relu.config.input_quantization_config[0].dominated_by = relu_out
