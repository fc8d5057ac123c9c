"""Calibration passes (redesign of ppq/quantization/optim/calibration.py).

RuntimeCalibrationPass drives the observer machinery: one forward sweep per
phase over the calibration dataloader, feeding every INITIAL activation TQC's
observer with the *pre-quant* tensor values, then rendering scale/offset.

The hooks run in the TorchExecutor, and the observers reduce on the
executor's device. The JAX package's compiled calibration
(optim/fcalibration.py) is not ported yet (ROADMAP.md queue 1, item 4), so
this pass always takes the observer path.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ...core import QuantizationStates, ppq_warning
from ...ir import BaseGraph, QuantableOperation
from ..observers import BaseTensorObserver, _TwoPhaseHistObserver, build_observer
from ...executor.base import QuantRuntimeHook
from .base import QuantizationOptimizationPass


class CalibrationHook(QuantRuntimeHook):
    """Feeds observers with pre-quant values (observer/__init__.py:40)."""

    def __init__(self, operation: QuantableOperation,
                 in_observers: Dict[int, BaseTensorObserver],
                 out_observers: Dict[int, BaseTensorObserver]):
        super().__init__(operation)
        self.in_observers = in_observers
        self.out_observers = out_observers

    def pre_forward_hook(self, inputs, quant_inputs=None, quant_configs=None,
                         **kwargs):
        for idx, obs in self.in_observers.items():
            if idx < len(inputs) and inputs[idx] is not None:
                obs.observe(inputs[idx])
        return quant_inputs if quant_inputs is not None else inputs

    def post_forward_hook(self, outputs, quant_outputs=None,
                          quant_configs=None, **kwargs):
        for idx, obs in self.out_observers.items():
            if idx < len(outputs) and outputs[idx] is not None:
                obs.observe(outputs[idx])
        return quant_outputs if quant_outputs is not None else outputs


class OperationObserver:
    """Builds observers for every INITIAL activation TQC of one op
    (observer/__init__.py:75)."""

    def __init__(self, operation: QuantableOperation,
                 monitor_parameters: bool = False,
                 monitor_outputs: bool = True,
                 monitor_inputs: bool = True):
        self.operation = operation
        self.in_observers: Dict[int, BaseTensorObserver] = {}
        self.out_observers: Dict[int, BaseTensorObserver] = {}
        if monitor_inputs:
            for idx, (var, cfg) in enumerate(
                    zip(operation.inputs, operation.config.input_quantization_config)):
                if var.is_parameter and not monitor_parameters:
                    continue
                if cfg.state == QuantizationStates.INITIAL and cfg.is_root:
                    self.in_observers[idx] = build_observer(cfg)
        if monitor_outputs:
            for idx, cfg in enumerate(operation.config.output_quantization_config):
                if cfg.state == QuantizationStates.INITIAL and cfg.is_root:
                    self.out_observers[idx] = build_observer(cfg)

    @property
    def observers(self) -> List[BaseTensorObserver]:
        return list(self.in_observers.values()) + list(self.out_observers.values())

    def hook(self) -> CalibrationHook:
        return CalibrationHook(self.operation, self.in_observers, self.out_observers)

    def render_quantization_config(self):
        for obs in self.observers:
            obs.render_quantization_config()


class RuntimeCalibrationPass(QuantizationOptimizationPass):
    """Observer-driven activation calibration
    (reference optim/calibration.py:19-215).

    method: override every activation TQC's observer algorithm (else each
    TQC's own `observer_algorithm` is used). Two-phase observers (kl, mse)
    trigger a second sweep over the dataloader automatically.
    """

    def __init__(self, method: Optional[str] = None, override: bool = False,
                 calib_steps: int = 32):
        super().__init__('Runtime Calibration Pass')
        self.method = method
        self.override = override
        self.calib_steps = calib_steps

    def calibrate(self, executor, dataloader, hooks, collate_fn=None):
        steps = 0
        for batch in dataloader:
            if collate_fn is not None:
                batch = collate_fn(batch)
            executor.forward(batch, hooks=hooks)
            steps += 1
            if steps >= self.calib_steps:
                break
        if steps == 0:
            raise ValueError('Calibration dataloader yielded no batches.')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        assert executor is not None and dataloader is not None, \
            'RuntimeCalibrationPass requires an executor and a dataloader'

        observers: List[OperationObserver] = []
        hooks: Dict[str, CalibrationHook] = {}
        for name, op in graph.operations.items():
            if not isinstance(op, QuantableOperation):
                continue
            if self.method is not None:
                for var, cfg in op.config_pairs():
                    if var.is_parameter:
                        continue
                    if cfg.state == QuantizationStates.INITIAL and \
                            (self.override or True):
                        cfg.observer_algorithm = self.method
            obs = OperationObserver(op)
            if obs.observers:
                observers.append(obs)
                hooks[name] = obs.hook()
        if not observers:
            return

        # phase 1
        self.calibrate(executor, dataloader, hooks, collate_fn)

        # phase 2 for histogram observers
        two_phase = [o for obs in observers for o in obs.observers
                     if isinstance(o, _TwoPhaseHistObserver)]
        if two_phase:
            for o in two_phase:
                o.start_phase2()
            self.calibrate(executor, dataloader, hooks, collate_fn)

        for obs in observers:
            obs.render_quantization_config()


class IsotoneCalibrationPass(RuntimeCalibrationPass):
    """Order-preserving calibration for decision-layer outputs
    (reference optim/calibration.py:325; observer/order.py:12). Sets the
    isotone observer on outputs of Softmax/Sigmoid ops, then calibrates."""

    def __init__(self, calib_steps: int = 32, axis: int = -1):
        super().__init__(calib_steps=calib_steps)
        self.name = 'Isotone Calibration Pass'
        self.axis = axis

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        from ...core import OBSERVER_ISOTONE_AXIS
        for op in graph.operations.values():
            if not isinstance(op, QuantableOperation):
                continue
            if op.type in {'Softmax', 'Sigmoid'}:
                for cfg in op.config.output_quantization_config:
                    if cfg.state == QuantizationStates.INITIAL:
                        cfg.observer_algorithm = 'isotone'
                        cfg.detail[OBSERVER_ISOTONE_AXIS] = self.axis
        super().optimize(graph, dataloader=dataloader, executor=executor,
                         collate_fn=collate_fn, **kwargs)
