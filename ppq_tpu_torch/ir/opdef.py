"""Static per-op dataflow model: OpSocket / VLink.

Capability-equivalent redesign of ppq/IR/base/opdef.py:138-958. For every op
type we declare, per ONNX spec:

  * which inputs carry shape-or-index (SOI) values (must stay un-quantized,
    usually computed on host) vs. ordinary activations;
  * which inputs must stay FP32 regardless of platform;
  * how *values* flow input→output inside the op (VLinks), which the
    dispatchers use to trace quantizable regions through the graph.

Instead of ~60 imperative socket-builder functions, the table here is
declarative: `(in_plats, out_plats, links)` per type, with sensible defaults
(all inputs UNSPECIFIED, dense input→output value links). `UNSPECIFIED`
means "follows whatever platform the dispatcher assigns the op".
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import TargetPlatform

U = TargetPlatform.UNSPECIFIED
S = TargetPlatform.SOI
F = TargetPlatform.FP32


class VLink:
    """A value-flow edge inside an op: values of input[in_idx] influence the
    *values* (not just shape) of output[out_idx]."""

    __slots__ = ('in_idx', 'out_idx')

    def __init__(self, in_idx: int, out_idx: int):
        self.in_idx = in_idx
        self.out_idx = out_idx

    def __repr__(self):
        return f'VLink({self.in_idx}->{self.out_idx})'


class OpSocket:
    """Static dataflow contract of one op instance."""

    def __init__(self, op, in_plat: Sequence[TargetPlatform],
                 out_plat: Sequence[TargetPlatform],
                 links: List[VLink]):
        self.op = op
        self.in_plat = list(in_plat)
        self.out_plat = list(out_plat)
        self.links = links

    def __repr__(self):
        return (f'OpSocket({self.op.type}, in={[p.name for p in self.in_plat]}, '
                f'out={[p.name for p in self.out_plat]})')


# --------------------------------------------------------------------------
# Declarative socket specs.
#   key: op type
#   value: (input platform pattern, output platform pattern, link spec)
# Platform patterns are lists indexed by position; if the op has more inputs
# than the pattern, the last entry repeats. Link spec:
#   'dense'          — every input links to every output
#   'first'          — only input[0] links to every output
#   list of tuples   — explicit (in_idx, out_idx) pairs
# References: ppq/IR/base/opdef.py socket builders (Reshape:201, Pad:221,
# Gather:253, Resize:277, Slice, Split, TopK, NMS, ...).
# --------------------------------------------------------------------------
_SOCKET_SPECS: Dict[str, Tuple[List[TargetPlatform], List[TargetPlatform], object]] = {
    # -- shape consumers: trailing SOI inputs ------------------------------
    'Reshape':          ([U, S], [U], 'first'),
    'Expand':           ([U, S], [U], 'first'),
    'Tile':             ([U, S], [U], 'first'),
    'Unsqueeze':        ([U, S], [U], 'first'),
    'Squeeze':          ([U, S], [U], 'first'),
    'Split':            ([U, S], [U], 'first'),
    'Slice':            ([U, S, S, S, S], [U], 'first'),
    'Pad':              ([U, S, U, S], [U], [(0, 0), (2, 0)]),
    'Resize':           ([U, S, S, S], [U], 'first'),
    'Upsample':         ([U, S], [U], 'first'),
    'Gather':           ([U, S], [U], 'first'),
    'GatherElements':   ([U, S], [U], 'first'),
    'GatherND':         ([U, S], [U], 'first'),
    'ScatterElements':  ([U, S, U], [U], [(0, 0), (2, 0)]),
    'ScatterND':        ([U, S, U], [U], [(0, 0), (2, 0)]),
    'TopK':             ([U, S], [U, S], [(0, 0)]),
    'Clip':             ([U, F, F], [U], 'first'),
    'Reciprocal':       ([U], [U], 'dense'),
    'CumSum':           ([U, S], [U], 'first'),
    'OneHot':           ([S, S, U], [U], [(2, 0)]),
    'RoiAlign':         ([U, F, S], [U], [(0, 0)]),
    'MaxRoiPool':       ([U, F], [U], [(0, 0)]),
    'GridSample':       ([U, F], [U], [(0, 0)]),
    'NonMaxSuppression': ([F, F, S, F, F], [S], []),
    'Range':            ([S, S, S], [S], 'dense'),

    # -- SOI generators: outputs are shape/index values --------------------
    'Shape':            ([U], [S], []),
    'NonZero':          ([U], [S], []),
    'ConstantOfShape':  ([S], [U], []),
    'Size':             ([U], [S], []),

    # -- ops whose outputs stay FP32 (probability-like / unquantable) ------
    'Softmax':          ([U], [U], 'dense'),
    'LogSoftmax':       ([U], [U], 'dense'),

    # -- recurrent: X, W, R, B, sequence_lens(SOI), initial_h, initial_c --
    'LSTM':             ([U, U, U, U, S, U, U, U], [U, U, U], 'dense'),
    'GRU':              ([U, U, U, U, S, U, U], [U, U], 'dense'),
    'RNN':              ([U, U, U, U, S, U], [U, U], 'dense'),

    # -- misc with constant/fp side inputs ---------------------------------
    'Where':            ([S, U, U], [U], [(1, 0), (2, 0)]),
    'PRelu':            ([U, U], [U], 'dense'),
    'BatchNormalization': ([U, F, F, F, F], [U], 'first'),
    'InstanceNormalization': ([U, F, F], [U], 'first'),
    'LayerNormalization': ([U, F, F], [U], 'first'),
    'GroupNormalization': ([U, F, F], [U], 'first'),
    'Dropout':          ([U, F], [U, S], [(0, 0)]),
}

# ops where the value link is "dense" but all inputs follow the op platform —
# anything not in _SOCKET_SPECS gets this default.
_DEFAULT_SPEC = ([U], [U], 'dense')


def socket_of(op) -> OpSocket:
    """Materialize the OpSocket for a concrete op instance."""
    in_pattern, out_pattern, link_spec = _SOCKET_SPECS.get(op.type, _DEFAULT_SPEC)
    n_in, n_out = len(op.inputs), len(op.outputs)
    in_plat = [in_pattern[i] if i < len(in_pattern) else in_pattern[-1]
               for i in range(n_in)]
    out_plat = [out_pattern[i] if i < len(out_pattern) else out_pattern[-1]
                for i in range(n_out)]
    if link_spec == 'dense':
        links = [VLink(i, j) for i in range(n_in) for j in range(n_out)]
    elif link_spec == 'first':
        links = [VLink(0, j) for j in range(n_out)] if n_in else []
    else:
        links = [VLink(i, j) for (i, j) in link_spec if i < n_in and j < n_out]
    return OpSocket(op, in_plat, out_plat, links)


def soi_input_indices(op) -> List[int]:
    """Input positions that carry shape-or-index values for this op."""
    return [i for i, p in enumerate(socket_of(op).in_plat) if p == S]


def fp32_input_indices(op) -> List[int]:
    return [i for i, p in enumerate(socket_of(op).in_plat) if p == F]
