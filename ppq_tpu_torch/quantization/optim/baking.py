"""Parameter baking (redesign of ppq/quantization/optim/baking.py:11).

Statically applies fake-quant to every ACTIVATED/PASSIVE parameter so the
runtime (and especially the whole-graph compiled path) does zero quant math
on weights — they become constants of the XLA program.
"""

from __future__ import annotations

from ...ir import BaseGraph, QuantableOperation
from ..qfunction import fake_quant_np
from .base import QuantizationOptimizationPass


class ParameterBakingPass(QuantizationOptimizationPass):
    def __init__(self):
        super().__init__('Parameter Baking Pass')

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        for op in graph.operations.values():
            if isinstance(op, QuantableOperation):
                op.baking_parameters(fake_quant_np)
