"""Native checkpoint importer/exporter (port of
ppq_tpu/frontends/native.py; redesign of ppq/parser/native.py:60).

The .native format is the full-state checkpoint: the whole BaseGraph — ops,
variables, parameter values, TQCs including dominator/master links — via the
core serialization layer (core/storage.py), versioned. The pickle
names the port's classes (`ppq_tpu_torch.*`), so a file written by either
package loads only in that package; interop/carry.py carries a graph's
parameters and TQCs across.
"""

from __future__ import annotations

from typing import Optional

from ..core import dump_native, load_native
from ..ir import BaseGraph, GraphBuilder, GraphExporter


class NativeExporter(GraphExporter):
    def export(self, file_path: str, graph: BaseGraph,
               config_path: Optional[str] = None, **kwargs):
        dump_native(graph, file_path)


class NativeImporter(GraphBuilder):
    def build(self, file_path: str, **kwargs) -> BaseGraph:
        return load_native(file_path)
