"""Cross-layer weight equalization machinery
(redesign of ppq/quantization/algorithm/equalization.py:27-434).

Port of ppq_tpu/quantization/algorithm/equalization.py: host numpy in
float32, step for step, so the rescaled weights equal the JAX package's bit
for bit.

Nagel et al. data-free equalization: for a pair of directly-connected
computing layers (optionally through a piecewise-linear activation), scale
channel c of the upstream layer by 1/s_c and the matching input channel of
the downstream layer by s_c with s_c = sqrt(r1_c / r2_c) — ranges equalize,
the function is unchanged.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...ir import BaseGraph, Operation

# ops transparent to equalization (relay ops, reference equalization.py:292)
RELAY_TYPES = {'Relu', 'LeakyRelu', 'PRelu', 'MaxPool', 'GlobalMaxPool',
               'Identity', 'Dropout'}


class EqualizationHelper:
    """Weight access per op kind (reference: equalization.py:27-199)."""

    @staticmethod
    def out_channel_axis(op: Operation) -> int:
        if op.type == 'Conv':
            return 0
        if op.type == 'ConvTranspose':
            return 1
        if op.type == 'Gemm':
            return 0 if int(op.attributes.get('transB', 0)) else 1
        raise TypeError(f'Unsupported op for equalization: {op.type}')

    @staticmethod
    def in_channel_axis(op: Operation) -> int:
        if op.type == 'Conv':
            return 1
        if op.type == 'ConvTranspose':
            return 0
        if op.type == 'Gemm':
            return 1 if int(op.attributes.get('transB', 0)) else 0
        raise TypeError(f'Unsupported op for equalization: {op.type}')

    @classmethod
    def key_value_from_upstream(cls, op: Operation,
                                including_bias=False,
                                bias_multiplier=0.5) -> np.ndarray:
        """Per-out-channel |w| range of the upstream layer."""
        w = np.asarray(op.inputs[1].value)
        axis = cls.out_channel_axis(op)
        moved = np.moveaxis(w, axis, 0).reshape(w.shape[axis], -1)
        key = np.abs(moved)
        if including_bias and len(op.inputs) > 2:
            b = np.abs(np.asarray(op.inputs[2].value)).reshape(-1, 1)
            key = np.concatenate([key, b * bias_multiplier], axis=1)
        return key.max(axis=1)

    @classmethod
    def key_value_from_downstream(cls, op: Operation) -> np.ndarray:
        """Per-in-channel |w| range of the downstream layer."""
        w = np.asarray(op.inputs[1].value)
        axis = cls.in_channel_axis(op)
        if op.type == 'Conv' and int(op.attributes.get('group', 1)) > 1:
            # depthwise: in-channel == group axis 0
            axis = 0
        moved = np.moveaxis(w, axis, 0).reshape(w.shape[axis], -1)
        return np.abs(moved).max(axis=1)

    @classmethod
    def scale_upstream(cls, op: Operation, scale: np.ndarray,
                       including_bias=True):
        w_var = op.inputs[1]
        w = np.asarray(w_var.value)
        axis = cls.out_channel_axis(op)
        shape = [1] * w.ndim
        shape[axis] = -1
        w_var.value = (w / scale.reshape(shape)).astype(np.float32)
        if len(op.inputs) > 2 and op.inputs[2].is_parameter:
            b_var = op.inputs[2]
            b_var.value = (np.asarray(b_var.value) / scale).astype(np.float32)

    @classmethod
    def scale_downstream(cls, op: Operation, scale: np.ndarray):
        w_var = op.inputs[1]
        w = np.asarray(w_var.value)
        axis = cls.in_channel_axis(op)
        if op.type == 'Conv' and int(op.attributes.get('group', 1)) > 1:
            axis = 0
        shape = [1] * w.ndim
        shape[axis] = -1
        w_var.value = (w * scale.reshape(shape)).astype(np.float32)


class EqualizationPair:
    """(reference: equalization.py:292)"""

    def __init__(self, upstream: Operation, downstream: Operation):
        self.upstream = upstream
        self.downstream = downstream

    def equalize(self, value_threshold: float = 0.5,
                 including_bias: bool = False,
                 bias_multiplier: float = 0.5):
        up_key = EqualizationHelper.key_value_from_upstream(
            self.upstream, including_bias, bias_multiplier)
        dn_key = EqualizationHelper.key_value_from_downstream(self.downstream)
        if up_key.shape != dn_key.shape:
            return False
        scale = np.sqrt(np.maximum(up_key, 1e-12) /
                        np.maximum(dn_key, 1e-12))
        # threshold: don't touch channels with tiny dynamic range
        mask = np.maximum(up_key, dn_key) < value_threshold
        scale[mask] = 1.0
        scale = np.clip(scale, 1e-4, 1e4)
        EqualizationHelper.scale_upstream(self.upstream, scale)
        EqualizationHelper.scale_downstream(self.downstream, scale)
        return True


def find_equalization_pairs(graph: BaseGraph) -> List[EqualizationPair]:
    """Direct (Conv|Gemm|ConvTranspose) → [relay]* → (Conv|Gemm|ConvTranspose)
    chains where the link is single-producer/single-consumer
    (reference pairs via SearchableGraph, equalization.py:214)."""
    pairs = []
    for op in graph.topological_sort():
        if op.type not in {'Conv', 'ConvTranspose', 'Gemm'}:
            continue
        cur = op
        ok = True
        while True:
            if len(cur.outputs) != 1:
                ok = False
                break
            out = cur.outputs[0]
            if out.name in graph.outputs or len(out.dest_ops) != 1:
                ok = False
                break
            nxt = out.dest_ops[0]
            if nxt.type in RELAY_TYPES:
                cur = nxt
                continue
            if nxt.type in {'Conv', 'ConvTranspose', 'Gemm'}:
                break
            ok = False
            break
        if not ok:
            continue
        downstream = out.dest_ops[0]
        try:
            up_key = EqualizationHelper.key_value_from_upstream(op)
            dn_key = EqualizationHelper.key_value_from_downstream(downstream)
        except (TypeError, IndexError):
            continue
        if up_key.shape == dn_key.shape:
            pairs.append(EqualizationPair(op, downstream))
    return pairs
