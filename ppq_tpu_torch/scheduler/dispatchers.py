"""Concrete graph dispatchers.

Capability-equivalent redesigns of ppq/scheduler/dispatchers.py (Aggresive:17,
Conservative:137, Point:418), allin.py:8 and perseus.py:9. All of them reduce
to: solve the SOI region, then choose how far the quantized region extends
from the computing ops (Conv/Gemm/MatMul/ConvTranspose).

TPU note: the quant/fp32 split maps onto XLA program regions — quantized ops
compile to int8/fp8 MXU paths, fp32 ops stay bf16/fp32, SOI ops become host
or scalar-core subprograms. A tight conservative region keeps fusion clusters
homogeneous, which XLA rewards.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Set

from ..core import COMPUTING_OP, TargetPlatform
from ..ir import BaseGraph, socket_of
from .base import GraphDispatcher, solve_soi_region


def _value_link_out_indices(op, in_idx: int) -> Set[int]:
    sck = socket_of(op)
    return {l.out_idx for l in sck.links if l.in_idx == in_idx}


class ConservativeDispatcher(GraphDispatcher):
    """Default dispatcher (ppq/scheduler/dispatchers.py:137).

    Quantizes only ops whose values are *derived from* a computing op via
    contiguous value links (the downstream closure), plus the computing ops
    themselves; everything else non-SOI stays fp32. This mirrors the
    reference's conservative value tracing and is the safest region map.
    """

    extend_upstream = False

    def dispatch(self, quant_types: Optional[Set[str]] = None,
                 quant_platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 fp32_platform: TargetPlatform = TargetPlatform.FP32,
                 soi_platform: TargetPlatform = TargetPlatform.SOI,
                 ) -> Dict[str, TargetPlatform]:
        graph = self.graph
        soi_ops = solve_soi_region(graph)
        quant_region: Set[str] = set()

        # forward closure from computing ops through value links
        frontier = deque(op for op in graph.operations.values()
                         if op.type in COMPUTING_OP)
        quant_region.update(op.name for op in frontier)
        seen = set(quant_region)
        while frontier:
            op = frontier.popleft()
            for out_var in op.outputs:
                for dest in out_var.dest_ops:
                    if dest.name in seen or dest.name in soi_ops:
                        continue
                    in_idx = dest.inputs.index(out_var)
                    sck = socket_of(dest)
                    plat = sck.in_plat[min(in_idx, len(sck.in_plat) - 1)]
                    if plat != TargetPlatform.UNSPECIFIED:
                        continue  # SOI/FP32-typed input: value leaves region
                    if not _value_link_out_indices(dest, in_idx) and dest.outputs:
                        # input does not flow into any output value
                        continue
                    seen.add(dest.name)
                    quant_region.add(dest.name)
                    frontier.append(dest)

        if self.extend_upstream:
            # aggressive variant: also pull in upstream ops feeding the
            # region through pure value links (ppq dispatchers.py:17).
            frontier = deque(graph.operations[n] for n in list(quant_region))
            while frontier:
                op = frontier.popleft()
                for in_idx, in_var in enumerate(op.inputs):
                    src = in_var.source_op
                    if src is None or src.name in seen or src.name in soi_ops:
                        continue
                    sck = socket_of(op)
                    plat = sck.in_plat[min(in_idx, len(sck.in_plat) - 1)]
                    if plat != TargetPlatform.UNSPECIFIED:
                        continue
                    seen.add(src.name)
                    quant_region.add(src.name)
                    frontier.append(src)

        table: Dict[str, TargetPlatform] = {}
        for name, op in graph.operations.items():
            if name in soi_ops:
                table[name] = soi_platform
            elif name in quant_region and (
                    quant_types is None or op.type in quant_types):
                table[name] = quant_platform
            else:
                table[name] = fp32_platform
        return table


class AggressiveDispatcher(ConservativeDispatcher):
    """Extends the quant region upstream as well
    (ppq/scheduler/dispatchers.py:17)."""

    extend_upstream = True


class AllinDispatcher(GraphDispatcher):
    """Everything non-SOI is quantized (ppq/scheduler/allin.py:8) — for
    backends that quantize the whole net (Tengine-style)."""

    def dispatch(self, quant_types: Optional[Set[str]] = None,
                 quant_platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 fp32_platform: TargetPlatform = TargetPlatform.FP32,
                 soi_platform: TargetPlatform = TargetPlatform.SOI,
                 ) -> Dict[str, TargetPlatform]:
        soi_ops = solve_soi_region(self.graph)
        table = {}
        for name, op in self.graph.operations.items():
            if name in soi_ops:
                table[name] = soi_platform
            elif quant_types is None or op.type in quant_types:
                table[name] = quant_platform
            else:
                table[name] = fp32_platform
        return table


class PointDispatcher(GraphDispatcher):
    """Only computing ops themselves are quantized
    (ppq/scheduler/dispatchers.py:418) — weight-only / pointwise schemes."""

    def dispatch(self, quant_types: Optional[Set[str]] = None,
                 quant_platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 fp32_platform: TargetPlatform = TargetPlatform.FP32,
                 soi_platform: TargetPlatform = TargetPlatform.SOI,
                 ) -> Dict[str, TargetPlatform]:
        soi_ops = solve_soi_region(self.graph)
        table = {}
        for name, op in self.graph.operations.items():
            if name in soi_ops:
                table[name] = soi_platform
            elif op.type in COMPUTING_OP and (
                    quant_types is None or op.type in quant_types):
                table[name] = quant_platform
            else:
                table[name] = fp32_platform
        return table


class PPLNNDispatcher(GraphDispatcher):
    """Fusion-aware dispatcher for PPLNN-style backends
    (ppq/scheduler/dispatchers.py:278).

    Distinct from Conservative in three ways:
      * the quantized region grows only from **Conv** seeds (the backend's
        INT8 kernels are conv-fusion clusters), not from every computing op;
      * growth relays only through the backend's fusable op set
        (`quant_types`) — an op outside it breaks the INT8 region even if a
        value link exists;
      * Shape/TopK/NonMaxSuppression and linear activations (Relu/Clip)
      inherit their producer's platform so fusion clusters stay whole.
    This reproduces the detection-model dispatch recipe (BASELINE.md uses
    dispatcher=pplnn for the COCO rows).
    """

    def dispatch(self, quant_types: Optional[Set[str]] = None,
                 quant_platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 fp32_platform: TargetPlatform = TargetPlatform.FP32,
                 soi_platform: TargetPlatform = TargetPlatform.SOI,
                 ) -> Dict[str, TargetPlatform]:
        graph = self.graph
        soi_ops = solve_soi_region(graph)
        quant_region: Set[str] = set()

        frontier = deque(op for op in graph.operations.values()
                         if op.type == 'Conv' and op.name not in soi_ops)
        quant_region.update(op.name for op in frontier)
        seen = set(quant_region)
        while frontier:
            op = frontier.popleft()
            for out_var in op.outputs:
                for dest in out_var.dest_ops:
                    if dest.name in seen or dest.name in soi_ops:
                        continue
                    if dest.type != 'Conv' and (
                            quant_types is not None and
                            dest.type not in quant_types):
                        continue          # not fusable by the backend
                    in_idx = dest.inputs.index(out_var)
                    sck = socket_of(dest)
                    plat = sck.in_plat[min(in_idx, len(sck.in_plat) - 1)]
                    if plat != TargetPlatform.UNSPECIFIED:
                        continue          # SOI/FP32-typed input slot
                    if not _value_link_out_indices(dest, in_idx) \
                            and dest.outputs:
                        continue          # value does not flow onward
                    seen.add(dest.name)
                    quant_region.add(dest.name)
                    frontier.append(dest)

        table: Dict[str, TargetPlatform] = {}
        for name, op in graph.operations.items():
            if name in soi_ops:
                table[name] = soi_platform
            elif name in quant_region and (
                    quant_types is None or op.type in quant_types
                    or op.type == 'Conv'):
                table[name] = quant_platform
            else:
                table[name] = fp32_platform

        # fusion-cluster repair: SOI generators and linear activations
        # follow their producing op's platform (dispatchers.py:402-416)
        from ..core.common import LINEAR_ACTIVATIONS
        for name, op in graph.operations.items():
            if op.type in {'Shape', 'TopK', 'NonMaxSuppression'}:
                src = op.inputs[0].source_op if op.inputs else None
                table[name] = (table[src.name] if src is not None
                               else fp32_platform)
            elif op.type in LINEAR_ACTIVATIONS and op.inputs:
                src = op.inputs[0].source_op
                if src is not None:
                    table[name] = table[src.name]
        return table


class PerseusDispatcher(GraphDispatcher):
    """Transitive-closure dispatcher (ppq/scheduler/perseus.py:9).

    Solves the full closure of value flow over VLinks: a variable is
    *activation-carrying* iff some chain of value links connects it to a
    computing op's main output or the graph inputs; ops all of whose
    produced values are activation-carrying and that sit on a quantable
    path are quantized. In practice this yields the conservative region
    plus transparent pre-compute chains, computed without any data.
    """

    def dispatch(self, quant_types: Optional[Set[str]] = None,
                 quant_platform: TargetPlatform = TargetPlatform.UNSPECIFIED,
                 fp32_platform: TargetPlatform = TargetPlatform.FP32,
                 soi_platform: TargetPlatform = TargetPlatform.SOI,
                 ) -> Dict[str, TargetPlatform]:
        graph = self.graph
        soi_ops = solve_soi_region(graph)

        # closure: var name → carries activation values
        act_vars: Set[str] = set(graph.inputs.keys())
        changed = True
        while changed:
            changed = False
            for name, op in graph.operations.items():
                if name in soi_ops:
                    continue
                sck = socket_of(op)
                for link in sck.links:
                    if link.in_idx >= len(op.inputs):
                        continue
                    if link.out_idx >= len(op.outputs):
                        continue
                    src = op.inputs[link.in_idx]
                    dst = op.outputs[link.out_idx]
                    if (src.name in act_vars or src.is_parameter) \
                            and dst.name not in act_vars:
                        act_vars.add(dst.name)
                        changed = True
                if op.type in COMPUTING_OP:
                    for out in op.outputs:
                        if out.name not in act_vars:
                            act_vars.add(out.name)
                            changed = True

        table: Dict[str, TargetPlatform] = {}
        for name, op in graph.operations.items():
            if name in soi_ops:
                table[name] = soi_platform
                continue
            quantable = bool(op.outputs) and all(
                v.name in act_vars for v in op.outputs)
            # ops with no output value links at all (pure SOI generators
            # like Shape) are never quantized
            sck = socket_of(op)
            if not sck.links and any(p == TargetPlatform.SOI
                                     for p in sck.out_plat):
                quantable = False
            if quantable and (quant_types is None or op.type in quant_types):
                table[name] = quant_platform
            else:
                table[name] = fp32_platform
        return table
