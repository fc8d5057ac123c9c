"""Pass framework (redesign of ppq/quantization/optim/base.py:8-90).

A pass mutates the quantization *control state* of a graph (TQC states,
scales, sharing links, sometimes graph structure). Passes are composed into
an ordered pipeline; the quantizer builds the pipeline from the
QuantizationSetting flags.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Optional

from ...core import ppq_info
from ...ir import BaseGraph


class QuantizationOptimizationPass:
    """Base pass (reference optim/base.py:8)."""

    def __init__(self, name: str = 'Quantization Optimization Pass'):
        self.name = name

    def optimize(self, graph: BaseGraph, dataloader: Optional[Iterable] = None,
                 executor=None, **kwargs) -> None:
        raise NotImplementedError

    def apply(self, graph: BaseGraph, dataloader=None, executor=None, **kwargs):
        self.optimize(graph, dataloader=dataloader, executor=executor, **kwargs)

    def __repr__(self):
        return f'<Pass {self.name}>'


class QuantizationOptimizationPipeline:
    """Ordered pass list with timing report (reference optim/base.py:31-90)."""

    def __init__(self, passes: Optional[List[QuantizationOptimizationPass]] = None):
        self._passes: List[QuantizationOptimizationPass] = list(passes or [])

    def append(self, p: QuantizationOptimizationPass) -> 'QuantizationOptimizationPipeline':
        self._passes.append(p)
        return self

    def append_front(self, p: QuantizationOptimizationPass) -> 'QuantizationOptimizationPipeline':
        self._passes.insert(0, p)
        return self

    def __iter__(self) -> Iterator[QuantizationOptimizationPass]:
        return iter(self._passes)

    def __len__(self):
        return len(self._passes)

    def __contains__(self, cls) -> bool:
        return any(isinstance(p, cls) for p in self._passes)

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 verbose: bool = True, **kwargs):
        for p in self._passes:
            start = time.time()
            p.optimize(graph, dataloader=dataloader, executor=executor, **kwargs)
            if verbose:
                ppq_info(f'[Pass] {p.name:<40s} finished in '
                         f'{time.time() - start:6.2f}s')
