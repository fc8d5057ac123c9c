"""Parameter quantization passes
(redesign of ppq/quantization/optim/parameters.py).

ParameterQuantizePass calibrates weight TQCs directly from the stored
parameter values (no forward needed — parameters are static, so a single
observe() of the full tensor is exact, unlike activations).

PassiveParameterQuantizePass derives scales for *passive* parameters that
must share quantization grids with their activations: bias scale =
input_scale * weight_scale (so int32 bias adds exactly onto the int32
accumulator), Clip min/max and Pad constant share the input scale.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core import QuantizationStates, ppq_warning
from ...ir import BaseGraph, QuantableOperation
from ..observers import build_observer
from .base import QuantizationOptimizationPass


class ParameterQuantizePass(QuantizationOptimizationPass):
    """Weight calibration (reference optim/parameters.py:156)."""

    def __init__(self, method: Optional[str] = None):
        super().__init__('Parameter Quantization Pass')
        self.method = method

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        # weights live on the host and the reductions are tiny: the
        # observers reduce them on the CPU, as the JAX package does
        self._calibrate_parameters(graph)

    def _calibrate_parameters(self, graph: BaseGraph):
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            for var, cfg in zip(op.inputs, op.config.input_quantization_config):
                if not var.is_parameter or not var.has_value:
                    continue
                if cfg.state != QuantizationStates.INITIAL or not cfg.is_root:
                    continue
                if self.method is not None:
                    cfg.observer_algorithm = self.method
                obs = build_observer(cfg)
                obs.observe(np.asarray(var.value, np.float32))
                obs.render_quantization_config()


class PassiveParameterQuantizePass(QuantizationOptimizationPass):
    """Derive passive-parameter scales (reference optim/parameters.py:13).

    * Conv/Gemm/ConvTranspose/MatMul bias: scale = act_scale * weight_scale,
      offset 0 (per-channel when the weight is per-channel).
    * Clip min/max, Pad value: share the op input's scale (master link).
    """

    def __init__(self, clip_passive: bool = True,
                 process_clip: bool = True, process_pad: bool = True):
        super().__init__('Passive Parameter Quantization Pass')
        self.process_clip = process_clip
        self.process_pad = process_pad

    @staticmethod
    def _resolved(cfg) -> bool:
        try:
            return cfg.has_scale
        except Exception:
            return False

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            if op.type in {'Conv', 'ConvTranspose', 'Gemm', 'MatMul',
                           'PPQBiasFusedMatMul'}:
                self._quantize_bias(op)
            elif op.type == 'Clip' and self.process_clip:
                self._share_input_scale(op, param_indices=(1, 2))
            elif op.type == 'Pad' and self.process_pad:
                self._share_input_scale(op, param_indices=(2,))

    def _quantize_bias(self, op: QuantableOperation):
        if len(op.inputs) < 3:
            return
        in_cfg, w_cfg, b_cfg = op.config.input_quantization_config[:3]
        b_var = op.inputs[2]
        if not b_var.is_parameter:
            return
        if b_cfg.state not in {QuantizationStates.PASSIVE_INIT,
                               QuantizationStates.INITIAL}:
            return
        if not (self._resolved(in_cfg) and self._resolved(w_cfg)):
            ppq_warning(f'Cannot derive bias scale of {op.name}: '
                        f'activation/weight not calibrated yet.')
            return
        in_scale = np.asarray(in_cfg.scale, np.float64).reshape(-1)
        w_scale = np.asarray(w_cfg.scale, np.float64)
        scale = (in_scale if in_scale.size == 1 else float(in_scale.max())) * w_scale
        b_cfg.scale = scale.astype(np.float32)
        b_cfg.offset = np.zeros_like(scale, np.float32)
        b_cfg.state = QuantizationStates.PASSIVE

    def _share_input_scale(self, op: QuantableOperation, param_indices):
        in_cfg = op.config.input_quantization_config[0]
        for idx in param_indices:
            if idx >= len(op.inputs):
                continue
            var = op.inputs[idx]
            cfg = op.config.input_quantization_config[idx]
            if not var.is_parameter:
                continue
            if cfg.state not in {QuantizationStates.PASSIVE_INIT,
                                 QuantizationStates.INITIAL}:
                continue
            cfg.master_by = in_cfg
