"""Graph block partitioning for blockwise finetuning
(redesign of ppq/quantization/algorithm/training.py:191-316 BlockBuilder /
TrainableBlock).

A TrainableBlock is a single-entry/single-exit (SESE) region: its start op
dominates and its end op post-dominates every member, so no path enters or
leaves mid-block — block boundaries never slice through a residual join
(the greedy contiguous-span splitter this replaces could cut between a
branch and its Add, inflating cached I/O and degrading LSQ/AdaRound).

Each block is one finetuning unit: cache its quantized inputs and fp32
reference outputs, then optimize weights/scales inside the block only. A
block runs through the executor's `partial_graph_forward`
(executor/executor.py), with the autograd graph recorded when it is trained.
Pure Python, a copy of the JAX package's module.

Algorithm: dominators and post-dominators over the op DAG (iterative
intersection in topo order, virtual source/sink for multi-entry/exit
graphs). From each unassigned op s, walk the post-dominator chain
s → pdom(s) → pdom²(s)…, keeping the farthest candidate e that s also
dominates and whose between-set stays within the computing-op budget; the
block is every op on an s→e path. Ops with no valid extension become
singleton blocks (the reference's {p, p, {p}} minimal block).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ...core import COMPUTING_OP
from ...ir import BaseGraph, Operation, QuantableOperation


class TrainableBlock:
    """(reference: algorithm/training.py:172 TrainableBlock(sp, ep, rps))"""

    def __init__(self, ops: List[Operation], graph: BaseGraph):
        assert ops, 'empty block'
        self.rps = list(ops)
        self.sp = ops[0]
        self.ep = ops[-1]
        produced = {v.name for op in ops for v in op.outputs}
        self.input_names = sorted({
            v.name for op in ops for v in op.inputs
            if not v.is_parameter and v.name not in produced})
        in_block = set(id(op) for op in ops)
        self.output_names = sorted({
            v.name for op in ops for v in op.outputs
            if v.name in graph.outputs or
            any(id(d) not in in_block for d in v.dest_ops)})

    @property
    def num_computing_ops(self) -> int:
        return sum(1 for op in self.rps if op.type in COMPUTING_OP)

    def has_trainable_op(self) -> bool:
        return any(isinstance(op, QuantableOperation) for op in self.rps)

    def __repr__(self):
        return (f'TrainableBlock({self.sp.name} → {self.ep.name}, '
                f'{len(self.rps)} ops, {self.num_computing_ops} computing)')


def _immediate_dominators(n_nodes: int, order: Sequence[int],
                          preds: Sequence[Sequence[int]],
                          root: int) -> List[Optional[int]]:
    """Iterative idom over a DAG given a topological order (root first).
    Single pass suffices on acyclic graphs."""
    idom: List[Optional[int]] = [None] * n_nodes
    idom[root] = root
    pos = {n: i for i, n in enumerate(order)}

    def intersect(a: int, b: int) -> int:
        while a != b:
            while pos[a] > pos[b]:
                a = idom[a]
            while pos[b] > pos[a]:
                b = idom[b]
        return a

    for n in order:
        if n == root:
            continue
        new = None
        for p in preds[n]:
            if idom[p] is None:
                continue
            new = p if new is None else intersect(new, p)
        idom[n] = new if new is not None else root
    return idom


class BlockBuilder:
    """(reference: algorithm/training.py:191)"""

    def __init__(self, graph: BaseGraph):
        self.graph = graph
        self._order = graph.topological_sort()
        self._idx = {op.name: i for i, op in enumerate(self._order)}
        n = len(self._order)

        succs: List[List[int]] = [[] for _ in range(n)]
        preds: List[List[int]] = [[] for _ in range(n)]
        for i, op in enumerate(self._order):
            for d in graph.get_downstream_operations(op):
                j = self._idx[d.name]
                succs[i].append(j)
                preds[j].append(i)

        # virtual source (index n) feeds entry ops; virtual sink (n+1)
        # drains exit ops — handles multi-input/multi-output graphs
        SRC, SNK = n, n + 1
        preds_f = [list(p) for p in preds] + [[], []]
        succs_f = [list(s) for s in succs] + [[], []]
        for i in range(n):
            if not preds[i]:
                preds_f[i].append(SRC)
                succs_f[SRC].append(i)
            if not succs[i]:
                succs_f[i].append(SNK)
                preds_f[SNK].append(i)
        fwd_order = [SRC] + list(range(n)) + [SNK]
        self._dom = _immediate_dominators(n + 2, fwd_order, preds_f, SRC)
        rev_order = [SNK] + list(range(n - 1, -1, -1)) + [SRC]
        self._pdom = _immediate_dominators(n + 2, rev_order, succs_f, SNK)
        self._succs = succs
        self._preds = preds
        self._n = n
        self._SRC, self._SNK = SRC, SNK

        # depth (longest path from an entry), reference initialize_depth
        self.depth = [0] * n
        for i in range(n):
            self.depth[i] = 1 + max((self.depth[p] for p in preds[i]),
                                    default=-1)

    def _dominates(self, a: int, b: int) -> bool:
        """a dom b over the forward graph (walk b's idom chain)."""
        while b != self._SRC:
            if b == a:
                return True
            b = self._dom[b]
        return False

    def _between(self, s: int, e: int) -> Optional[List[int]]:
        """All nodes on s→e paths: reachable from s AND reaching e.
        Returns topo-sorted indices, or None if e is unreachable."""
        if s == e:
            return [s]
        down = {s}
        stack = [s]
        while stack:
            cur = stack.pop()
            if cur == e:
                continue
            for nxt in self._succs[cur]:
                # a node on an s→e path precedes e in every topo order
                if nxt not in down and nxt <= e:
                    down.add(nxt)
                    stack.append(nxt)
        if e not in down:
            return None
        up = {e}
        stack = [e]
        while stack:
            cur = stack.pop()
            for p in self._preds[cur]:
                if p in down and p not in up:
                    up.add(p)
                    stack.append(p)
        if s not in up:
            return None
        return sorted(up)

    def build_block(self, start: Operation, block_size: int = 4,
                    max_depth: int = 64) -> TrainableBlock:
        """Largest SESE block from `start` within the computing-op budget
        (reference build(), algorithm/training.py:216)."""
        s = self._idx[start.name]
        members = self._grow(s, block_size, max_depth, assigned=None)
        return TrainableBlock([self._order[i] for i in members], self.graph)

    def _grow(self, s: int, block_size: int, max_depth: int,
              assigned: Optional[set]) -> List[int]:
        best = [s]
        e = self._pdom[s]
        while e not in (self._SNK, self._SRC, None):
            if self.depth[e] - self.depth[s] > max_depth:
                break
            if not self._dominates(s, e):
                e = self._pdom[e]
                continue
            members = self._between(s, e)
            if members is None:
                break
            if assigned is not None and any(m in assigned for m in members
                                            if m != s):
                break
            n_comp = sum(1 for m in members
                         if self._order[m].type in COMPUTING_OP)
            if n_comp > block_size:
                break
            best = members
            e = self._pdom[e]
        return best

    def build(self, block_size: int = 4,
              only_quantable: bool = True) -> List[TrainableBlock]:
        """Partition the whole graph into SESE blocks of ≤ block_size
        computing ops each."""
        assigned: set = set()
        blocks: List[TrainableBlock] = []
        for i in range(self._n):
            if i in assigned:
                continue
            members = self._grow(i, block_size, max_depth=4 * block_size + 8,
                                 assigned=assigned)
            assigned.update(members)
            blocks.append(TrainableBlock(
                [self._order[m] for m in members], self.graph))
        if only_quantable:
            blocks = [b for b in blocks if b.has_trainable_op()]
        return blocks
