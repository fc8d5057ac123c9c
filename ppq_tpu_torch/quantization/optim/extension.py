"""User extension pass template (redesign of
ppq/quantization/optim/extension.py:10); port of
ppq_tpu/quantization/optim/extension.py."""

from __future__ import annotations

from ...ir import BaseGraph
from .base import QuantizationOptimizationPass


class ExtensionPass(QuantizationOptimizationPass):
    """Subclass and override optimize() — enabled via
    QuantizationSetting.extension."""

    def __init__(self, name: str = 'Extension Pass'):
        super().__init__(name)

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        pass
