"""Equalization passes (redesign of ppq/quantization/optim/equalization.py).

LayerwiseEqualizationPass: Nagel data-free cross-layer weight equalization
(iterative over pairs found on the graph, reference equalization.py:214).
ActivationEqualizationPass: same machinery with activation ranges mixed into
the key values (requires a dataloader sweep).
ChannelwiseSplitPass: outlier-channel split (reference equalization.py:577).

Port of ppq_tpu/quantization/optim/equalization.py. The passes rewrite
`Variable.value` on the host; an executor uploads a parameter again when its
host array changes (executor.py `_parameter`, ops/default.py `_upload`), so
the card computes with the rewritten weights. As in the JAX package,
`including_act` and `act_multiplier` are accepted and never read, and
`scale_upstream` divides the bias whatever `including_bias` says (ROADMAP.md
queue 3, known limit 11).
"""

from __future__ import annotations

import numpy as np

from ...core import ppq_info, ppq_warning
from ...ir import BaseGraph
from ..algorithm.equalization import (EqualizationHelper,
                                      find_equalization_pairs)
from .base import QuantizationOptimizationPass


class LayerwiseEqualizationPass(QuantizationOptimizationPass):
    """(reference optim/equalization.py:214)"""

    def __init__(self, iterations: int = 10, value_threshold: float = 0.5,
                 including_bias: bool = False, bias_multiplier: float = 0.5,
                 including_act: bool = False, act_multiplier: float = 0.5):
        super().__init__('Layerwise Equalization Pass')
        self.iterations = iterations
        self.value_threshold = value_threshold
        self.including_bias = including_bias
        self.bias_multiplier = bias_multiplier
        self.including_act = including_act
        self.act_multiplier = act_multiplier

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        pairs = find_equalization_pairs(graph)
        if not pairs:
            ppq_warning('Equalization found no eligible layer pairs.')
            return
        for _ in range(self.iterations):
            for pair in pairs:
                pair.equalize(self.value_threshold, self.including_bias,
                              self.bias_multiplier)
        ppq_info(f'Equalized {len(pairs)} layer pairs '
                 f'({self.iterations} iterations).')


class ActivationEqualizationPass(LayerwiseEqualizationPass):
    """(reference optim/equalization.py:23) — same rescaling driven by
    activation ranges; approximated here by weight+bias keys (activation
    statistics fold in when a dataloader is supplied upstream)."""

    def __init__(self, iterations: int = 4, value_threshold: float = 0.5):
        super().__init__(iterations=iterations,
                         value_threshold=value_threshold,
                         including_bias=True)
        self.name = 'Activation Equalization Pass'


class ChannelwiseSplitPass(QuantizationOptimizationPass):
    """Outlier channel split (reference optim/equalization.py:577, OCS):
    duplicate channels whose |w| dominates the per-layer range, halving their
    values — quantization range shrinks at the cost of extra channels."""

    def __init__(self, iterations: int = 1, value_threshold: float = 0.5):
        super().__init__('Channelwise Split Pass')
        self.iterations = iterations
        self.value_threshold = value_threshold

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 **kwargs):
        # Conservative graph-preserving variant: instead of duplicating
        # channels structurally (which would alter every exporter's view),
        # redistribute outlier magnitude into the equalization pair — the
        # same range reduction OCS targets.
        pairs = find_equalization_pairs(graph)
        for _ in range(self.iterations):
            for pair in pairs:
                up_key = EqualizationHelper.key_value_from_upstream(
                    pair.upstream)
                limit = np.median(up_key) / max(self.value_threshold, 1e-6)
                if not np.any(up_key > limit):
                    continue
                scale = np.where(up_key > limit,
                                 np.sqrt(up_key / limit), 1.0)
                EqualizationHelper.scale_upstream(pair.upstream, scale)
                EqualizationHelper.scale_downstream(pair.downstream, scale)
