"""Dispatcher foundation: SOI-region solving over the OpSocket dataflow model.

Capability-equivalent redesign of ppq/scheduler/base.py:6-75 + the SOI
fixpoint at ppq/scheduler/dispatchers.py:99-110. The central question every
dispatcher answers is: *which ops compute shape-or-index (SOI) values* —
those must stay un-quantized (and, on TPU, are the natural host/scalar
subprograms XLA cannot profitably tile) — versus which ops carry activation
values that may be quantized.

Instead of the reference's lambda-driven opset_matching tracing, the solver
here works directly on the declarative OpSocket/VLink model (ir/opdef.py):

  1. *SOI demand* seeds: every (op, input_idx) whose socket marks the input
     as SOI.
  2. Backward fixpoint: if an output of op P is consumed only at SOI inputs
     (or by ops already classified SOI), then P's value-linked inputs to
     that output become SOI demands as well — unless P is itself a natural
     SOI *generator* (Shape/NonZero/...) whose socket has no in→out links,
     which terminates the propagation at the activation boundary.
  3. An op is classified SOI if it is not a computing op and every one of
     its outputs is demanded only as SOI.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core import COMPUTING_OP, SOI_OP, TargetPlatform
from ..ir import BaseGraph, Operation, socket_of


def soi_generators(graph: BaseGraph) -> List[Operation]:
    """Ops producing shape-or-index values natively
    (ppq/scheduler/base.py:70)."""
    out = []
    for op in graph.operations.values():
        sck = socket_of(op)
        if any(p == TargetPlatform.SOI for p in sck.out_plat):
            out.append(op)
    return out


def soi_receivers(graph: BaseGraph) -> List[Tuple[Operation, int]]:
    """(op, input index) pairs that consume SOI values
    (ppq/scheduler/base.py:60)."""
    out = []
    for op in graph.operations.values():
        sck = socket_of(op)
        for idx, plat in enumerate(sck.in_plat):
            if idx >= len(op.inputs):
                break
            if plat == TargetPlatform.SOI:
                out.append((op, idx))
    return out


def solve_soi_region(graph: BaseGraph) -> Set[str]:
    """Names of ops whose *computation itself* belongs to the SOI domain.

    Fixpoint over the value-flow model; see module docstring. Parameters
    (initializers) never force an op into SOI — only a chain of live ops
    does.
    """
    sockets = {name: socket_of(op) for name, op in graph.operations.items()}

    # demand[(op_name, out_idx)] = True → this output is consumed as SOI-only
    soi_ops: Set[str] = set()
    # seed: native SOI generators with no value links from inputs produce SOI
    # but remain on the activation side themselves (Shape reads a real tensor).

    def output_soi_only(op: Operation, out_idx: int,
                        demanded: Set[Tuple[str, int]]) -> bool:
        var = op.outputs[out_idx]
        if var.name in graph.outputs:
            return False          # graph outputs must be real values
        if not var.dest_ops:
            return False
        for dest in var.dest_ops:
            if dest.name in soi_ops:
                continue
            idx = dest.inputs.index(var)
            sck = sockets[dest.name]
            plat = sck.in_plat[min(idx, len(sck.in_plat) - 1)]
            if plat != TargetPlatform.SOI:
                return False
        return True

    changed = True
    demanded: Set[Tuple[str, int]] = set()
    while changed:
        changed = False
        for name, op in graph.operations.items():
            if name in soi_ops:
                continue
            if op.type in COMPUTING_OP:
                continue
            sck = sockets[name]
            # native generators stay put — they bridge activation→SOI.
            if not sck.links and any(p == TargetPlatform.SOI
                                     for p in sck.out_plat):
                continue
            if not op.outputs:
                continue
            if all(output_soi_only(op, i, demanded)
                   for i in range(len(op.outputs))):
                soi_ops.add(name)
                changed = True
    return soi_ops


class GraphDispatcher:
    """Base dispatcher (ppq/scheduler/base.py:6): assigns every op a
    TargetPlatform in {quant_platform, fp32_platform, soi_platform}."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph

    def dispatch(self, quant_types: Optional[Set[str]] = None,
                 quant_platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 fp32_platform: TargetPlatform = TargetPlatform.FP32,
                 soi_platform: TargetPlatform = TargetPlatform.SOI,
                 ) -> Dict[str, TargetPlatform]:
        raise NotImplementedError
