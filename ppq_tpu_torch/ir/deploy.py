"""Deployment-side IR helpers (port of ppq_tpu/ir/deploy.py; redesign of
ppq/IR/deploy.py:13 RunnableGraph, ppq/IR/training.py:11 TrainableGraph,
and ppq/IR/morph.py:1161 GraphDeviceSwitcher).

RunnableGraph moves a graph's float parameters between host numpy and
torch tensors on a device, the card unless the caller names another;
GraphDeviceSwitcher materializes the scheduler's SOI split as explicit
PPQDeviceSwitch boundary ops, which the executor runs as host<->device
transfers (executor/ops/default.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core import TargetPlatform
from .graph import BaseGraph, Operation


class RunnableGraph:
    """Move parameter storage between host and device
    (reference IR/deploy.py:13-136)."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph
        self._on_device: Dict[str, object] = {}

    def deploy(self, device=None):
        """Copy every float parameter to `device`, the card unless the
        caller names another (reference `deploy`:76)."""
        import torch
        from ..executor.executor import resolve_device
        target = resolve_device(device)
        for name, var in self.graph.variables.items():
            if var.is_parameter and var.has_value:
                val = np.asarray(var.value)
                if np.issubdtype(val.dtype, np.floating):
                    self._on_device[name] = torch.as_tensor(val,
                                                            device=target)
        return self

    def retrieve(self):
        """Pull parameters back to host numpy (reference `retrieve`:55)."""
        for name, t in self._on_device.items():
            self.graph.variables[name].value = t.detach().cpu().numpy()
        self._on_device.clear()
        return self

    def device_value(self, name: str):
        return self._on_device.get(name)


class TrainableGraph:
    """Expose graph parameters as a trainable set
    (reference IR/training.py:11-38)."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def parameters(self) -> Dict[str, np.ndarray]:
        return {name: var.value for name, var in self.graph.variables.items()
                if var.is_parameter and var.has_value and
                np.issubdtype(np.asarray(var.value).dtype, np.floating)}

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {k: np.array(v, copy=True)
                for k, v in self.parameters().items()}

    def load_state_dict(self, state: Dict[str, np.ndarray]):
        for name, value in state.items():
            if name in self.graph.variables:
                self.graph.variables[name].value = np.asarray(value)

    def zero_grad(self):
        """Gradients live on the tensors a training pass makes
        (executor.forward_with_gradient's `parameters`), not on the IR's
        numpy values: kept for API parity."""
        return None


class GraphDeviceSwitcher:
    """Insert/remove explicit device-boundary ops at SOI edges
    (reference IR/morph.py:1161)."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def _is_host(self, op: Operation) -> bool:
        return op.platform == TargetPlatform.SOI

    def insert_switcher(self) -> int:
        """Insert a PPQDeviceSwitch on every edge crossing the SOI boundary."""
        inserted = 0
        for var in list(self.graph.variables.values()):
            if var.is_parameter or var.source_op is None:
                continue
            src_host = self._is_host(var.source_op)
            for dest in list(var.dest_ops):
                if dest.type == 'PPQDeviceSwitch':
                    continue
                dst_host = self._is_host(dest)
                if src_host == dst_host:
                    continue
                direction = 'to_host' if dst_host else 'to_device'
                sw_out = self.graph.create_variable(
                    f'{var.name}_sw{inserted}')
                sw = self.graph.create_operation(
                    'PPQDeviceSwitch', name=f'{var.name}_switch{inserted}',
                    attributes={'direction': direction},
                    inputs=[var], outputs=[sw_out],
                    platform=TargetPlatform.BOUNDARY)
                for i, v in enumerate(dest.inputs):
                    if v is var:
                        dest.inputs[i] = sw_out
                sw_out.dest_ops.append(dest)
                var.dest_ops.remove(dest)
                inserted += 1
        return inserted

    def remove_switcher(self) -> int:
        """Strip PPQDeviceSwitch ops before export
        (reference GraphDeviceSwitcher.remove_switcher)."""
        removed = 0
        for op in [o for o in self.graph.operations.values()
                   if o.type == 'PPQDeviceSwitch']:
            self.graph.remove_operation(op, keep_coherence=True)
            removed += 1
        return removed
