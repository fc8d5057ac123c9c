"""Graph pattern/search engine (redesign of ppq/IR/search.py:28-690).

Query families, all lambda-driven:

  * path_matching    — enumerate op paths sp → ... → ep where every hop
                       satisfies rp (relay predicate); forward or backward.
  * opset_matching   — flood-fill the set of ops reachable from sp through
                       rp, stopping at ep; returns an OperationSet.
  * pattern_matching — match a linear chain of type/predicate patterns
                       (the workhorse of fusion passes), optionally
                       'exclusive': interior ops must have a single consumer.
  * dag_matching     — full subgraph (DAG) pattern matching via GraphPattern
                       (reference GraphPattern + PatternMatchHelper.
                       match_burte_force, ppq/IR/search.py:166-390) — the
                       engine behind multi-branch fusions (self-attention,
                       layernorm, swish/mish).
  * TraversalCommand — string-query form of path/opset matching; the
                       reference defines the SELECT/FROM/TO/THROUGH grammar
                       but leaves `complie` unimplemented (search.py:136) —
                       here the compiler is functional.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set, Union

from .graph import BaseGraph, Operation

OpPredicate = Callable[[Operation], bool]
Pattern = Union[str, Sequence[str], OpPredicate]


class Path(list):
    """An ordered op chain."""

    def __repr__(self):
        return ' -> '.join(op.name for op in self)


class OperationSet(set):
    def filter(self, predicate: OpPredicate) -> 'OperationSet':
        return OperationSet(op for op in self if predicate(op))


def _as_predicate(pattern: Pattern) -> OpPredicate:
    if callable(pattern):
        return pattern
    if isinstance(pattern, str):
        return lambda op, t=pattern: op.type == t
    types = set(pattern)
    return lambda op, ts=types: op.type in ts


class GraphPattern:
    """A connected sub-DAG pattern: `nodes[i]` is a type string / predicate,
    `edges` are (producer_idx, consumer_idx) pairs (reference GraphPattern,
    ppq/IR/search.py:166). Must be acyclic and connected."""

    def __init__(self, nodes: Sequence[Pattern],
                 edges: Sequence[Sequence[int]]):
        self.preds = [_as_predicate(p) for p in nodes]
        n = len(self.preds)
        self.n = n
        self.parents: List[List[int]] = [[] for _ in range(n)]
        self.children: List[List[int]] = [[] for _ in range(n)]
        for e in edges:
            if len(e) != 2:
                raise ValueError(f'pattern edge {e!r} must be a pair')
            a, b = int(e[0]), int(e[1])
            if not (0 <= a < n and 0 <= b < n):
                raise IndexError(f'pattern edge {e!r} out of range 0..{n-1}')
            self.children[a].append(b)
            self.parents[b].append(a)
        # assignment order: start anywhere, always extend via an edge to an
        # already-placed node (keeps the candidate set small); doubles as the
        # connectivity check. Cycles are rejected via Kahn count.
        indeg = [len(p) for p in self.parents]
        stack = [i for i in range(n) if indeg[i] == 0]
        seen = 0
        work = list(indeg)
        while stack:
            cur = stack.pop()
            seen += 1
            for c in self.children[cur]:
                work[c] -= 1
                if work[c] == 0:
                    stack.append(c)
        if seen != n:
            raise ValueError('pattern contains a cycle')
        order = [0]
        placed = {0}
        while len(order) < n:
            for i in range(n):
                if i in placed:
                    continue
                if any(p in placed for p in self.parents[i]) or \
                        any(c in placed for c in self.children[i]):
                    order.append(i)
                    placed.add(i)
                    break
            else:
                raise ValueError('pattern is not connected')
        self.order = order
        self.roots = [i for i in range(n) if not self.parents[i]]
        self.leaves = [i for i in range(n) if not self.children[i]]


class SearchableGraph:
    """Query helper bound to a BaseGraph (ppq/IR/search.py:390)."""

    def __init__(self, graph: BaseGraph):
        self.graph = graph

    # ------------------------------------------------------------ traversal
    def _next(self, op: Operation, direction: str) -> List[Operation]:
        if direction == 'down':
            return self.graph.get_downstream_operations(op)
        return self.graph.get_upstream_operations(op)

    def path_matching(self, sp_expr: Pattern, rp_expr: Pattern,
                      ep_expr: Pattern, direction: str = 'down',
                      max_depth: int = 64) -> List[Path]:
        """All paths sp →(rp)*→ ep (ppq/IR/search.py:506)."""
        sp, rp, ep = map(_as_predicate, (sp_expr, rp_expr, ep_expr))
        results: List[Path] = []
        for op in self.graph.topological_sort():
            if not sp(op):
                continue
            stack: List[Path] = [Path([op])]
            while stack:
                path = stack.pop()
                tail = path[-1]
                for nxt in self._next(tail, direction):
                    if nxt in path:
                        continue
                    if ep(nxt):
                        results.append(Path(path + [nxt]))
                    if rp(nxt) and len(path) < max_depth:
                        stack.append(Path(path + [nxt]))
        return results

    def opset_matching(self, sp_expr: Pattern, rp_expr: Pattern,
                       ep_expr: Optional[Pattern] = None,
                       direction: str = 'down') -> OperationSet:
        """Flood-fill matching (ppq/IR/search.py:564): collect sp ops and
        everything reachable through rp; ep ops terminate expansion (and are
        included)."""
        sp = _as_predicate(sp_expr)
        rp = _as_predicate(rp_expr)
        ep = _as_predicate(ep_expr) if ep_expr is not None else (lambda op: False)
        result = OperationSet()
        frontier = [op for op in self.graph.operations.values() if sp(op)]
        result.update(frontier)
        while frontier:
            op = frontier.pop()
            for nxt in self._next(op, direction):
                if nxt in result:
                    continue
                if ep(nxt):
                    result.add(nxt)
                    continue
                if rp(nxt):
                    result.add(nxt)
                    frontier.append(nxt)
        return result

    # ----------------------------------------------------------- patterns
    def pattern_matching(self, patterns: Sequence[Pattern],
                         edges: Optional[Sequence[Sequence[int]]] = None,
                         exclusive: bool = True) -> List[List[Operation]]:
        """Match a chain (or small DAG) of patterns.

        With default edges, patterns form a linear chain p0→p1→...→pn.
        `exclusive` requires every interior op to have exactly one consumer
        (safe-to-fuse condition, ppq/IR/search.py:655).
        """
        preds = [_as_predicate(p) for p in patterns]
        n = len(preds)
        if edges is None:
            edges = [[i, i + 1] for i in range(n - 1)]
        adj: List[List[int]] = [[] for _ in range(n)]
        for a, b in edges:
            adj[a].append(b)
        results: List[List[Operation]] = []

        def extend(assign: List[Optional[Operation]], idx: int):
            if idx == n:
                results.append(list(assign))  # type: ignore[arg-type]
                return
            # find candidates: ops downstream of all already-assigned parents
            parents = [i for i in range(idx) if idx in adj[i]]
            if parents:
                cands: Optional[Set[Operation]] = None
                for p in parents:
                    downs = set(self.graph.get_downstream_operations(assign[p]))
                    cands = downs if cands is None else (cands & downs)
                candidates = list(cands or [])
            else:
                candidates = list(self.graph.operations.values())
            for op in candidates:
                if op in assign:
                    continue
                if not preds[idx](op):
                    continue
                if exclusive and parents:
                    ok = True
                    for p in parents:
                        src = assign[p]
                        if len(self.graph.get_downstream_operations(src)) != 1:
                            ok = False
                            break
                    if not ok:
                        continue
                assign.append(op)
                extend(assign, idx + 1)
                assign.pop()

        for op in self.graph.topological_sort():
            if preds[0](op):
                extend([op], 1)
        # de-dup (chains found once per root)
        seen, uniq = set(), []
        for r in results:
            key = tuple(o.name for o in r)
            if key not in seen:
                seen.add(key)
                uniq.append(r)
        return uniq

    def dag_matching(self, pattern: GraphPattern, exclusive: bool = True,
                     max_matches: int = 100000) -> List[List[Operation]]:
        """Enumerate every injective embedding of `pattern` into the graph
        (reference match_burte_force semantics, ppq/IR/search.py:288-390).

        Backtracking over `pattern.order`: each node after the first is
        adjacent to an already-assigned node, so candidates come from the
        assigned neighborhood, not the whole graph — typical cost is
        O(matches · pattern_size · fanout), not the reference's O(N·M^k)
        frontier product.

        `exclusive` enforces fusion safety: a matched non-root must draw ALL
        its inputs from within the match (and exactly its pattern in-degree
        of distinct producers); a matched non-leaf must send all its outputs
        into the match.
        """
        pt = pattern
        results: List[List[Operation]] = []
        assign: List[Optional[Operation]] = [None] * pt.n
        used: Set[str] = set()

        def feeds(a: Operation, b: Operation) -> bool:
            return any(b in v.dest_ops for v in a.outputs)

        def ok_here(idx: int, op: Operation) -> bool:
            if not pt.preds[idx](op) or op.name in used:
                return False
            for p in pt.parents[idx]:
                if assign[p] is not None and not feeds(assign[p], op):
                    return False
            for c in pt.children[idx]:
                if assign[c] is not None and not feeds(op, assign[c]):
                    return False
            return True

        def extend(pos: int):
            if len(results) >= max_matches:
                raise OverflowError(
                    'too many pattern matches; simplify the pattern')
            if pos == pt.n:
                if exclusive and not self._dag_exclusive(pt, assign):
                    return
                results.append(list(assign))
                return
            idx = pt.order[pos]
            cands: Optional[Set[Operation]] = None
            for p in pt.parents[idx]:
                if assign[p] is not None:
                    nxt = set(self.graph.get_downstream_operations(assign[p]))
                    cands = nxt if cands is None else cands & nxt
            for c in pt.children[idx]:
                if assign[c] is not None:
                    nxt = set(self.graph.get_upstream_operations(assign[c]))
                    cands = nxt if cands is None else cands & nxt
            pool = cands if cands is not None \
                else self.graph.operations.values()
            for op in pool:
                if ok_here(idx, op):
                    assign[idx] = op
                    used.add(op.name)
                    extend(pos + 1)
                    used.discard(op.name)
                    assign[idx] = None

        extend(0)
        # de-dup (symmetric patterns can reach the same embedding twice)
        seen, uniq = set(), []
        for r in results:
            key = tuple(o.name for o in r)
            if key not in seen:
                seen.add(key)
                uniq.append(r)
        return uniq

    def _dag_exclusive(self, pt: GraphPattern,
                       assign: List[Operation]) -> bool:
        matched = {op.name for op in assign}
        for idx, op in enumerate(assign):
            if idx not in pt.roots:
                ups = [u for u in self.graph.get_upstream_operations(op)]
                if any(u.name not in matched for u in ups):
                    return False
                if len(set(u.name for u in ups)) != len(set(pt.parents[idx])):
                    return False
            if idx not in pt.leaves:
                if any(d.name not in matched
                       for d in self.graph.get_downstream_operations(op)):
                    return False
        return True

    def activation_matching(self, start_op_types: Set[str],
                            end_types: Set[str]) -> dict:
        """computing-op → its direct activation op (ppq/IR/search.py:621)."""
        matches = {}
        for op in self.graph.operations.values():
            if op.type not in start_op_types:
                continue
            downs = self.graph.get_downstream_operations(op)
            if len(downs) == 1 and downs[0].type in end_types:
                matches[op.name] = downs[0]
        return matches

    def concat_matching(self, relay_pattern: Pattern,
                        end_pattern: Pattern) -> dict:
        """For each Concat, trace its input sources back through relay ops
        (ppq/IR/search.py:639)."""
        relay, end = _as_predicate(relay_pattern), _as_predicate(end_pattern)
        result = {}
        for op in self.graph.operations.values():
            if op.type != 'Concat':
                continue
            sources = []
            for up in self.graph.get_upstream_operations(op):
                node = up
                depth = 0
                while relay(node) and depth < 32:
                    ups = self.graph.get_upstream_operations(node)
                    if len(ups) != 1:
                        break
                    node = ups[0]
                    depth += 1
                if end(node):
                    sources.append(node)
            result[op.name] = sources
        return result

    def traverse(self, command: 'TraversalCommand'):
        """Execute a TraversalCommand against this graph."""
        if command.matching_type == 'opset':
            return self.opset_matching(command.sp_expr, command.rp_expr,
                                       command.ep_expr,
                                       direction=command.direction)
        paths = self.path_matching(command.sp_expr, command.rp_expr,
                                   command.ep_expr,
                                   direction=command.direction)
        if command.where is not None:
            paths = [p for p in paths if command.where(p)]
        if command.select == 'START':
            return OperationSet(p[0] for p in paths)
        if command.select == 'END':
            return OperationSet(p[-1] for p in paths)
        return paths


class TraversalCommand:
    """Declarative path/opset query (reference TraversalCommand,
    ppq/IR/search.py:81-136). The reference documents a SELECT/FROM/TO/
    THROUGH/WHERE string grammar but leaves its `complie` a `pass`; here
    `compile` is implemented.

    Query grammar (case-insensitive keywords, one clause per line or
    semicolon-separated)::

        SELECT  START | END | PATH
        FROM    Conv, Gemm          # start-point op types ('Any' matches all)
        TO      Relu                # end-point op types
        THROUGH Any                 # relay op types
        WHERE   Path.length < 3     # optional path filter
        [DIRECTION up|down]

    Example::

        cmd = TraversalCommand.compile('''
            SELECT START
            FROM Conv, Gemm
            TO Relu
            THROUGH Any
            WHERE Path.length < 3''')
        starts = SearchableGraph(graph).traverse(cmd)
    """

    def __init__(self, sp_expr: Pattern, rp_expr: Pattern, ep_expr: Pattern,
                 direction: str = 'down', matching_type: str = 'path',
                 select: str = 'PATH',
                 where: Optional[Callable[[Path], bool]] = None):
        if matching_type not in ('path', 'opset'):
            raise ValueError("matching_type must be 'path' or 'opset'")
        if direction not in ('up', 'down'):
            raise ValueError("direction must be 'up' or 'down'")
        self.sp_expr = sp_expr
        self.rp_expr = rp_expr
        self.ep_expr = ep_expr
        self.direction = direction
        self.matching_type = matching_type
        self.select = select.upper()
        self.where = where

    @staticmethod
    def compile(query: str) -> 'TraversalCommand':
        import re
        clauses: Dict[str, str] = {}
        for raw in re.split(r'[;\n]', query):
            line = raw.strip()
            if not line:
                continue
            m = re.match(r'(SELECT|FROM|TO|THROUGH|WHERE|DIRECTION)\s+(.*)',
                         line, re.IGNORECASE)
            if m is None:
                raise ValueError(f'cannot parse query clause: {line!r}')
            clauses[m.group(1).upper()] = m.group(2).strip()

        def type_clause(text: Optional[str]) -> Pattern:
            if text is None or text.strip().lower() == 'any':
                return lambda op: True
            types = {t.strip().strip('\'"') for t in text.split(',')
                     if t.strip()}
            return lambda op, ts=types: op.type in ts

        select = clauses.get('SELECT', 'PATH').strip().strip('\'"').upper()
        if select not in ('START', 'END', 'PATH', 'OPSET'):
            raise ValueError(f'SELECT must be START/END/PATH/OPSET, '
                             f'got {select!r}')
        where = None
        if 'WHERE' in clauses:
            import re as _re
            m = _re.match(r'Path\.length\s*(<|<=|>|>=|==)\s*(\d+)',
                          clauses['WHERE'], _re.IGNORECASE)
            if m is None:
                raise ValueError(f'unsupported WHERE clause: '
                                 f'{clauses["WHERE"]!r} (use Path.length '
                                 f'<op> N)')
            import operator
            cmp = {'<': operator.lt, '<=': operator.le, '>': operator.gt,
                   '>=': operator.ge, '==': operator.eq}[m.group(1)]
            bound = int(m.group(2))
            where = lambda path, c=cmp, b=bound: c(len(path), b)
        return TraversalCommand(
            sp_expr=type_clause(clauses.get('FROM')),
            rp_expr=type_clause(clauses.get('THROUGH')),
            ep_expr=type_clause(clauses.get('TO')),
            direction=clauses.get('DIRECTION', 'down').lower(),
            matching_type='opset' if select == 'OPSET' else 'path',
            select=select if select != 'OPSET' else 'PATH',
            where=where)
