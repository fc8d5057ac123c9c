"""Experimental passes
(redesign of ppq/quantization/optim/exprimental.py — LearningToCalibPass:18,
MatrixFactorizationPass:184).

Port of ppq_tpu/quantization/optim/experimental.py. The activations a hook
samples may lie on the card; `tensor_random_fetch` reads them to the host,
and the search and the SVD run in numpy as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...core import QuantizationStates, ppq_info, ppq_warning
from ...ir import BaseGraph, QuantableOperation
from ...utils.fetch import tensor_random_fetch
from .base import QuantizationOptimizationPass
from .calibration import CalibrationHook


class LearningToCalibPass(QuantizationOptimizationPass):
    """Per-tensor calibration search (reference exprimental.py:18): after a
    baseline calibration, each activation TQC's scale is refined by a grid
    search over clip multipliers minimizing the fake-quant MSE on sampled
    activation values — the deterministic core of the reference's RL-flavored
    'learning to calibrate'."""

    def __init__(self, multipliers: Optional[List[float]] = None,
                 calib_steps: int = 8, samples_per_tensor: int = 4096):
        super().__init__('Learning To Calibrate Pass')
        self.multipliers = multipliers or [0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.25]
        self.calib_steps = calib_steps
        self.samples = samples_per_tensor

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        assert executor is not None and dataloader is not None

        # 1. collect sampled pre-quant activations per calibrated TQC
        sample_store: Dict[int, List[np.ndarray]] = {}
        targets = {}
        hooks = {}
        for name, op in graph.operations.items():
            if not isinstance(op, QuantableOperation):
                continue
            in_obs, out_obs = {}, {}
            for idx, (var, cfg) in enumerate(
                    zip(op.inputs, op.config.input_quantization_config)):
                if var.is_parameter or not cfg.is_root:
                    continue
                if cfg.state == QuantizationStates.ACTIVATED:
                    targets[hash(cfg)] = cfg
                    in_obs[idx] = cfg
            for idx, cfg in enumerate(op.config.output_quantization_config):
                if cfg.is_root and cfg.state == QuantizationStates.ACTIVATED:
                    targets[hash(cfg)] = cfg
                    out_obs[idx] = cfg
            if in_obs or out_obs:
                hooks[name] = _SamplingHook(op, in_obs, out_obs,
                                            sample_store, self.samples)
        if not targets:
            return
        steps = 0
        for batch in dataloader:
            if collate_fn is not None:
                batch = collate_fn(batch)
            executor.forward(batch, hooks=hooks)
            steps += 1
            if steps >= self.calib_steps:
                break

        # 2. grid search per TQC
        from ..qfunction import fake_quant_np
        improved = 0
        for key, cfg in targets.items():
            if key not in sample_store or not cfg.has_scale:
                continue
            samples = np.concatenate(sample_store[key])
            base_scale = np.asarray(cfg.scale)
            base_offset = np.asarray(cfg.offset)
            best_m, best_err = 1.0, None
            for m in self.multipliers:
                cfg.scale = base_scale * m
                qs = fake_quant_np(samples, cfg)
                err = float(np.mean((qs - samples) ** 2))
                if best_err is None or err < best_err:
                    best_err, best_m = err, m
            cfg.scale = base_scale * best_m
            cfg.offset = base_offset
            if best_m != 1.0:
                improved += 1
        ppq_info(f'LearningToCalib refined {improved}/{len(targets)} '
                 f'tensor scales.')


class _SamplingHook(CalibrationHook):
    def __init__(self, op, in_cfgs, out_cfgs, store, n_samples):
        super().__init__(op, {}, {})
        self._op = op
        self._in_cfgs = in_cfgs
        self._out_cfgs = out_cfgs
        self._store = store
        self._n = n_samples

    def pre_forward_hook(self, inputs, quant_inputs=None, quant_configs=None,
                         **kwargs):
        for idx, cfg in self._in_cfgs.items():
            if idx < len(inputs) and inputs[idx] is not None:
                self._store.setdefault(hash(cfg), []).append(
                    tensor_random_fetch(inputs[idx], self._n))
        return quant_inputs if quant_inputs is not None else inputs

    def post_forward_hook(self, outputs, quant_outputs=None,
                          quant_configs=None, **kwargs):
        for idx, cfg in self._out_cfgs.items():
            if idx < len(outputs) and outputs[idx] is not None:
                self._store.setdefault(hash(cfg), []).append(
                    tensor_random_fetch(outputs[idx], self._n))
        return quant_outputs if quant_outputs is not None else outputs


class MatrixFactorizationPass(QuantizationOptimizationPass):
    """SVD layer split (reference exprimental.py:184, manual-only): factor a
    Gemm/MatMul weight (in, out) into (in, r) @ (r, out), replacing the op
    with two chained MatMuls. Reduces per-layer dynamic range and parameter
    count when r < in*out/(in+out)."""

    def __init__(self, interested_layers: Optional[List[str]] = None,
                 rank_ratio: float = 0.5):
        super().__init__('Matrix Factorization Pass')
        self.interested_layers = interested_layers
        self.rank_ratio = rank_ratio

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        names = (self.interested_layers if self.interested_layers is not None
                 else [n for n, op in graph.operations.items()
                       if op.type in ('Gemm', 'MatMul')])
        for name in names:
            op = graph.operations.get(name)
            if op is None or op.type not in ('Gemm', 'MatMul'):
                ppq_warning(f'MatrixFactorization skips {name}')
                continue
            if len(op.inputs) < 2 or not op.inputs[1].is_parameter:
                continue
            if op.type == 'Gemm' and (
                    int(op.attributes.get('transA', 0)) or
                    int(op.attributes.get('transB', 0)) or
                    len(op.inputs) > 2):
                continue          # keep it to the plain y = x @ w case
            w = np.asarray(op.inputs[1].value, np.float32)
            if w.ndim != 2:
                continue
            cin, cout = w.shape
            r = max(1, int(min(cin, cout) * self.rank_ratio))
            u, s, vt = np.linalg.svd(w, full_matrices=False)
            a = (u[:, :r] * s[:r]).astype(np.float32)      # (cin, r)
            b = vt[:r, :].astype(np.float32)               # (r, cout)

            a_var = graph.create_variable(f'{name}_svd_a', value=a,
                                          is_parameter=True)
            b_var = graph.create_variable(f'{name}_svd_b', value=b,
                                          is_parameter=True)
            mid = graph.create_variable(f'{name}_svd_mid')
            x_var = op.inputs[0]
            out_var = op.outputs[0]

            m1 = graph.create_operation('MatMul', name=f'{name}_svd_1',
                                        inputs=[x_var, a_var], outputs=[mid],
                                        platform=op.platform)
            graph.remove_operation(op)
            m2 = graph.create_operation('MatMul', name=f'{name}_svd_2',
                                        inputs=[mid, b_var],
                                        outputs=[out_var],
                                        platform=m1.platform)
            ppq_info(f'Factorized {name}: ({cin}x{cout}) → '
                     f'({cin}x{r})({r}x{cout})')
