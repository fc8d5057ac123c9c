"""Deployment and benchmarking utilities (ppq_tpu/utils/deploy.py; the
reference's backend deploy helpers, ppq/utils/TensorRTUtil.py:380 engine
build and benchmark).

Where TensorRT builds a serialized engine from a QDQ ONNX file and the JAX
package serializes a StableHLO executable, the port's deployment artifact
is a `torch.export` program of the compiled forward's walk
(`executor/compile.py`, uncaptured), with the quantized weights baked in as
its buffers, saved by `torch.export.save`:

    export_compiled_artifact(graph, 'model.pt2')      # "engine build"
    run = load_compiled_artifact('model.pt2')         # "engine load"
    y = run(x)

Every fake-quant site is one opaque node of the program, a custom operator
of `kernels/ops.py` (the kernels on the card, their plain versions on the
CPU): loading imports `ppq_tpu_torch.kernels` to register them. The host
reads of shape operands in the walk are constants of the quantized graph
and fold while tracing. The precision travels with the artifact: the walk
sets PyTorch's TF32 flags (`simulation_precision`) and, for 'int', turns
`cudnn.benchmark` off around its integer contractions, and a program keeps
no flags, so the loaded program runs under the same flags, set around its
call ('int' as a whole under them: its contractions over integer codes are
exact in float32 as in TF32).

`benchmark_graph` mirrors TensorRTUtil.Benchmark (throughput sweep and
latency; adds MFU against the card's datasheet peak, `utils/flops.py`), and
`profile_graph` writes a torch.profiler trace (Chrome trace format).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_META = 'ppq_tpu_torch.json'


def _example_inputs(graph, batch: Optional[int] = None) -> Dict[str, np.ndarray]:
    feed = {}
    for name, var in graph.inputs.items():
        shape = list(var.shape or [1])
        if batch is not None and len(shape) >= 1:
            shape[0] = batch
        feed[name] = np.zeros(shape, np.float32)
    return feed


def _feed(inputs, names):
    """A dict of inputs, or one array for a one-input graph."""
    return list(inputs.values())[0] if len(names) == 1 else inputs


@contextlib.contextmanager
def _flags(precision: str):
    """The flags the walk runs under: its precision's TF32 setting, and
    for 'int' cuDNN's heuristic algorithms (`_integer_contraction`)."""
    from ..executor.ops.default import simulation_precision
    benchmark = torch.backends.cudnn.benchmark
    if precision == 'int':
        torch.backends.cudnn.benchmark = False
    try:
        with torch.no_grad(), simulation_precision(precision):
            yield
    finally:
        torch.backends.cudnn.benchmark = benchmark


class _Walk(torch.nn.Module):
    """The compiled graph's inference walk as a module, its parameters (as
    the runner uploads them) buffers."""

    def __init__(self, cg, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cg = cg
        self.param_names = list(params)
        for i, value in enumerate(params.values()):
            self.register_buffer(f'p{i}', value)

    def forward(self, *inputs):
        params = {name: getattr(self, f'p{i}')
                  for i, name in enumerate(self.param_names)}
        return tuple(self.cg._walk(
            params, dict(zip(self.cg._input_names, inputs))))


def export_compiled_artifact(graph, path: str, precision: str = 'default',
                             batch: Optional[int] = None,
                             device=None) -> str:
    """Export the (quantized) graph's compiled forward at its input shapes
    (batch `batch` where given) as one program with the weights baked in,
    and save it at `path`. Returns the path. The counterpart of TensorRT's
    engine build; runs on the card unless `device` names another."""
    from ..executor.compile import compile_graph
    cg = compile_graph(graph, precision=precision, device=device)
    module = _Walk(cg, cg.init_params())
    example = cg._feed(_example_inputs(graph, batch))
    args = tuple(example[name] for name in cg._input_names)
    # one real walk first: it uploads the device scales and host operands
    # that the traced walk then reads as constants
    with _flags(precision):
        module(*args)
        program = torch.export.export(module, args, strict=False)
    meta = {'precision': precision, 'inputs': list(cg._input_names),
            'outputs': list(cg.output_names)}
    torch.export.save(program, path, extra_files={_META: json.dumps(meta)})
    return path


def load_compiled_artifact(path: str):
    """Load an artifact; returns run(inputs_dict_or_array) -> [outputs] on
    the device it was exported for. The counterpart of TensorRT's engine
    deserialize."""
    from .. import kernels  # noqa: F401  (registers the custom operators)
    extra = {_META: ''}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    module = program.module()
    device = next(iter(program.state_dict.values())).device \
        if program.state_dict else torch.device('cpu')
    names = meta['inputs']

    def run(inputs):
        if not isinstance(inputs, dict):
            inputs = {names[0]: inputs}
        args = [torch.as_tensor(np.asarray(inputs[n]) if not isinstance(
            inputs[n], torch.Tensor) else inputs[n]).to(
            device=device, dtype=torch.float32).contiguous() for n in names]
        with _flags(meta['precision']):
            return list(module(*args))
    run.precision = meta['precision']
    return run


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def benchmark_graph(graph, batch_sizes: Sequence[int] = (1, 8, 64),
                    precision: str = 'default', iters: int = 20,
                    warmup: int = 2, device=None) -> List[dict]:
    """Throughput / latency sweep of the compiled graph's runner with
    device-resident inputs (reference: TensorRTUtil.Benchmark), one row a
    batch: items/s and ms a call by the host clock around calls that end in
    a synchronize, and MFU against the card's peak for the math type of
    `precision` (`flops.PRECISION_MATH`; None on the CPU or a card the
    table does not list)."""
    from ..executor.compile import compile_graph
    from .flops import PRECISION_MATH, graph_flops, mfu

    cg = compile_graph(graph, precision=precision, device=device)
    run = cg.make_runner()
    base_batch = None
    for var in graph.inputs.values():
        if var.shape:
            base_batch = int(var.shape[0])
            break
    flops_per_item = graph_flops(graph) / max(base_batch or 1, 1)

    rows = []
    names = list(graph.inputs)
    for batch in batch_sizes:
        feed = _feed(cg._feed(_example_inputs(graph, batch)), names)
        for _ in range(1 + warmup):
            run(feed)
        _sync(cg.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            run(feed)
        _sync(cg.device)
        dt = time.perf_counter() - t0
        ips = batch * iters / dt
        rows.append({'batch': batch, 'items_per_sec': ips,
                     'latency_ms': dt / iters * 1e3,
                     'mfu': mfu(flops_per_item, ips,
                                PRECISION_MATH[precision],
                                device=cg.device)})
    return rows


def profile_graph(graph, logdir: str, precision: str = 'default',
                  iters: int = 5, batch: Optional[int] = None,
                  device=None) -> str:
    """Write a torch.profiler timeline of the compiled runner's calls into
    `logdir` (trace.json, Chrome trace format; the card's kernels where it
    runs on one). The first call, which captures, runs before the trace."""
    from ..executor.compile import compile_graph
    from torch.profiler import ProfilerActivity, profile
    cg = compile_graph(graph, precision=precision, device=device)
    run = cg.make_runner()
    feed = _feed(cg._feed(_example_inputs(graph, batch)), list(graph.inputs))
    run(feed)
    _sync(cg.device)
    activities = [ProfilerActivity.CPU]
    if cg.device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            run(feed)
        _sync(cg.device)
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    return logdir
