"""Compiled (functional) calibration: the whole-graph calibration path.

Counterpart of ppq_tpu/quantization/optim/fcalibration.py. The observer path
(optim/calibration.py) hooks the eager executor: every batch pays a Python
dispatch per op and a host read per observer. Here the walk and the
statistics of every site run in one capture (executor/compile.py
`build_calibration_forward`): on the card, a batch is one CUDA graph replay,
its statistics fold into running ones on the device (`_make_fold`), and the
host reads them once, at the end.

Semantics match the eager observers:
  minmax     global min / max fold               (observers.MinMaxObserver)
  percentile per-batch quantile, averaged        (observers.PercentileObserver)
             by the exact 'percentile' kind on every device (top-k, as the
             observer); the JAX package bisects on the TPU instead
             ('quantile_bisect', a workaround for slow XLA sorts)
  kl / mse   ONE spec ('absmax_hist') run twice: sweep 1 learns the abs-max,
             sweep 2 fills the histograms at the final scale (captured anew:
             the scale is an argument of the histogram kernel), then the
             clip search (native library, quantization/solvers.py)
Histograms count in int64 on the device (the JAX package's in int32).
Isotone and the other algorithms take the observer path.

Data-parallel calibration (`mesh` with a 'dp' axis, the JAX package's
`mesh` argument): every rank of the mesh runs this pass on the same graph
and batches; each walks its dp shard of every batch through its own walk,
and the statistics are reduced over 'dp' (min / max by MIN / MAX, the
abs-max by MAX, the int64 histograms by SUM). A percentile site returns its
shard's top-k candidates ('percentile_topk'); every batch gathers them over
'dp' and takes the quantiles of the union, which are the whole batch's
(`observers.quantile_of_candidates`). So the scales are one card's on the
whole batches: bit for bit for minmax, KL and MSE, and percentile's exact
quantile (difference 25) alike.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ...core import (OBSERVER_KL_HIST_BINS, OBSERVER_MIN_SCALE,
                     OBSERVER_MSE_HIST_BINS, OBSERVER_PERCENTILE,
                     OBSERVER_PERCENTILE_MANUL_OVERRIDE, QuantizationStates,
                     TensorQuantizationConfig)
from ...executor.compile import CompiledGraph, compilable
from ...ir import BaseGraph, QuantableOperation
from ..observers import minmax_to_scale_offset, quantile_of_candidates
from ..solvers import kl_threshold_search, mse_threshold_search
from .base import QuantizationOptimizationPass

COMPILED_ALGOS = {'minmax', 'percentile', 'kl', 'mse'}

# profile of the most recent compiled calibration run:
# {'batches', 'images', 'compile_s', 'run_s'[, 'run2_s', 'search_s']}.
# compile_s is the first batch (its uncaptured walk, the capture and the
# first replay); run2_s includes sweep 2's capture
LAST_CALIBRATION_PROFILE = {}


def _make_fold(kinds: Dict[str, str]):
    """The on-device stat combiner: fold(acc, stats) -> acc. The first call
    copies the batch's stats (a capture's static tensors, overwritten by the
    next replay); later calls fold into acc in place. Percentile quantiles
    are summed in float32 and divided by the batch count at readback (the
    eager observers' average)."""

    def comb(kind, a, s):
        if kind == 'minmax':
            torch.minimum(a[0], s[0], out=a[0])
            torch.maximum(a[1], s[1], out=a[1])
        elif kind in ('percentile', 'quantile_bisect', 'percentile_topk'):
            a[0].add_(s[0])
            a[1].add_(s[1])
        elif kind == 'absmax_hist':
            torch.maximum(a[0], s[0], out=a[0])
            a[1].add_(s[1])
        elif kind == 'absmax':
            torch.maximum(a, s, out=a)
        else:                                 # hist / hist_signed
            a.add_(s)

    def copy(v):
        return tuple(x.clone() for x in v) if isinstance(v, tuple) \
            else v.clone()

    def fold(acc, stats):
        if acc is None:
            return {n: copy(v) for n, v in stats.items()}
        for n, v in stats.items():
            comb(kinds[n], acc[n], v)
        return acc
    return fold


def _activation_roots(graph: BaseGraph
                      ) -> Dict[str, List[TensorQuantizationConfig]]:
    """var name -> every INITIAL root activation TQC of that variable
    awaiting calibration, in graph order. A variable read by several
    quantized ops has one root per reader, and each is calibrated from the
    variable's one set of statistics, as the observer path gives each its
    own observer of the same tensor. The JAX package's compiled path keeps
    the first root only and leaves the others INITIAL (ROADMAP.md queue 3,
    recorded difference 39)."""
    roots: Dict[str, List[TensorQuantizationConfig]] = {}
    for op in graph.operations.values():
        if not isinstance(op, QuantableOperation):
            continue
        for var, cfg in op.config_pairs():
            if var.is_parameter:
                continue
            if cfg.is_root and cfg.state == QuantizationStates.INITIAL:
                seen = roots.setdefault(var.name, [])
                if all(cfg is not other for other in seen):
                    seen.append(cfg)
    return roots


def compiled_calibration_supported(graph: BaseGraph,
                                   method: Optional[str]) -> bool:
    ok, _ = compilable(graph)
    if not ok:
        return False
    if method is not None:
        return method in COMPILED_ALGOS
    # one statistic a variable: its roots must ask for one algorithm
    return all(cfg.observer_algorithm in COMPILED_ALGOS and
               cfg.observer_algorithm == cfgs[0].observer_algorithm
               for cfgs in _activation_roots(graph).values() for cfg in cfgs)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float64)


class CompiledCalibrationPass(QuantizationOptimizationPass):
    """Activation calibration through the compiled walk, on the device of
    the executor it is handed (the card unless that executor runs
    elsewhere). mesh: a mesh with a 'dp' axis (parallel.make_mesh): every
    rank of it calls the pass on the same batches, walks its dp shard of
    each, and the statistics reduce over 'dp'."""

    def __init__(self, method: Optional[str] = None, calib_steps: int = 32,
                 mesh=None):
        super().__init__('Compiled Calibration Pass (CUDA graphs)')
        self.method = method
        self.calib_steps = calib_steps
        self.mesh = mesh

    def _dp(self):
        """This rank's 'dp' line as (group, size); (None, 1) without one."""
        if self.mesh is None:
            return None, 1
        return self.mesh.group('dp'), self.mesh.shape.get('dp', 1)

    def _shard(self, feed: dict) -> dict:
        """This rank's dp shard of a fed batch."""
        if self.mesh is None:
            return feed
        from ...parallel.mesh import batch_sharding
        dp = self._dp()[1]
        out = {}
        for k, v in feed.items():
            if v.shape[0] % dp:
                raise ValueError(f'batch {v.shape[0]} of {k!r} does not '
                                 f'split over dp={dp}')
            out[k] = batch_sharding(self.mesh, v.dim()).local(v) \
                .contiguous()
        return out

    def _reduce(self, acc, kinds, sweep: int):
        """Sweep 1's minmax and abs-max, or sweep 2's histograms, reduced
        over 'dp' in place (the same bits on every rank)."""
        group, _ = self._dp()
        if group is None or acc is None:
            return acc
        from ...parallel.multihost import all_reduce
        for n, v in acc.items():
            if sweep == 2:
                all_reduce(v[1], group, 'sum')
            elif kinds[n] == 'minmax':
                all_reduce(v[0], group, 'min')
                all_reduce(v[1], group, 'max')
            elif kinds[n] == 'absmax_hist':
                all_reduce(v[0], group, 'max')
        return acc

    def _quantiles(self, stats, pct_of):
        """On a mesh, a batch's percentile candidates gathered over 'dp' ->
        the whole batch's (lo, hi) quantiles; other statistics (and every
        one without a mesh) as they are."""
        if self.mesh is None:
            return stats
        from ...parallel.multihost import all_gather
        group, _ = self._dp()
        out = dict(stats)
        for n, pct in pct_of.items():
            if n not in stats:
                continue
            lo_c, hi_c, total, per_channel = stats[n]
            lo_c = all_gather(lo_c, group, dim=1)
            hi_c = all_gather(hi_c, group, dim=1)
            lo = quantile_of_candidates(lo_c, 1.0 - pct, total)
            hi = quantile_of_candidates(hi_c, pct, total)
            if not per_channel:
                lo, hi = lo[0], hi[0]
            out[n] = (lo, hi)
        return out

    def _batches(self, dataloader, collate_fn):
        n = 0
        for batch in dataloader:
            if collate_fn is not None:
                batch = collate_fn(batch)
            yield batch
            n += 1
            if n >= self.calib_steps:
                break

    def optimize(self, graph: BaseGraph, dataloader=None, executor=None,
                 collate_fn=None, **kwargs):
        assert dataloader is not None, 'calibration requires a dataloader'
        roots = _activation_roots(graph)
        if not roots:
            return
        if self.method is not None:
            for cfgs in roots.values():
                for cfg in cfgs:
                    cfg.observer_algorithm = self.method
        targets = {name: cfgs[0] for name, cfgs in roots.items()}

        cg = CompiledGraph(graph, device=getattr(executor, 'device', None))
        params = cg.init_params()

        algo_of = {name: cfg.observer_algorithm
                   for name, cfg in targets.items()}
        onepass = {n for n, a in algo_of.items() if a == 'minmax'}
        percentile = {n for n, a in algo_of.items() if a == 'percentile'}
        twophase = {n for n, a in algo_of.items() if a in ('kl', 'mse')}

        spec = {}
        for n in onepass:
            spec[n] = {'kind': 'minmax'}
        # sorted: the ranks of a mesh gather the sites in one order (a set's
        # order follows each process's string hashes)
        pct_of = {n: float(targets[n].detail.get(
            OBSERVER_PERCENTILE_MANUL_OVERRIDE, OBSERVER_PERCENTILE))
            for n in sorted(percentile)}
        for n in percentile:
            spec[n] = ({'kind': 'percentile', 'percentile': pct_of[n]}
                       if self.mesh is None else
                       {'kind': 'percentile_topk', 'percentile': pct_of[n],
                        'world': self._dp()[1]})
        for n in twophase:
            bins = (OBSERVER_KL_HIST_BINS if algo_of[n] == 'kl'
                    else OBSERVER_MSE_HIST_BINS)
            spec[n] = {'kind': 'absmax_hist', 'bins': bins}
        # sweep 1's histogram scales: placeholders, as in the JAX package
        ranges1 = {n: np.float32(1.0) for n in sorted(twophase)} or None

        # the calibration window goes to the device once, before any sweep
        # (sweep 2 reads every batch again)
        feeds: List[dict] = []
        n_images = 0
        for batch in self._batches(dataloader, collate_fn):
            feed = cg._feed(batch)
            n_images += int(next(iter(feed.values())).shape[0])
            feeds.append(self._shard(feed))
        if not feeds:
            raise ValueError('Calibration dataloader yielded no batches.')

        fn = cg.build_calibration_forward(spec)
        kinds = {n: e['kind'] for n, e in spec.items()}
        fold = _make_fold(kinds)
        acc = None
        compile_s = run_s = 0.0
        for i, feed in enumerate(feeds):
            t0 = time.perf_counter()
            _, stats = fn(params, feed, ranges1)
            acc = fold(acc, self._quantiles(stats, pct_of))
            dt = time.perf_counter() - t0
            if i == 0:
                compile_s = dt
            else:
                run_s += dt
        n_batches = len(feeds)
        t0 = time.perf_counter()
        acc = self._reduce(acc, kinds, sweep=1)
        # one read of what the host needs: sweep 1's histograms are
        # placeholders and stay on the device
        acc_host = {n: ((_host(v[0]),) if kinds[n] == 'absmax_hist'
                        else tuple(_host(x) for x in v)
                        if isinstance(v, tuple) else _host(v))
                    for n, v in (acc or {}).items()}
        run_s += time.perf_counter() - t0
        LAST_CALIBRATION_PROFILE.clear()
        LAST_CALIBRATION_PROFILE.update({
            'batches': n_batches, 'images': n_images,
            'compile_s': compile_s, 'run_s': run_s})

        for name in onepass:
            if name in acc_host:
                lo, hi = acc_host[name]
                for cfg in roots[name]:
                    self._activate(cfg, *minmax_to_scale_offset(lo, hi, cfg))
        for name in percentile:
            if name in acc_host:
                # eager-observer semantics: per-batch quantiles, averaged
                lo, hi = acc_host[name]
                for cfg in roots[name]:
                    self._activate(cfg, *minmax_to_scale_offset(
                        lo / n_batches, hi / n_batches, cfg))

        if not twophase:
            return
        # sweep 2: the same spec at the real histogram scales, a new capture
        absmax = {n: float(np.max(acc_host[n][0]))
                  for n in twophase if n in acc_host}
        hist_scales, ranges2 = {}, dict(ranges1)
        for n in twophase:
            bins = (OBSERVER_KL_HIST_BINS if algo_of[n] == 'kl'
                    else OBSERVER_MSE_HIST_BINS)
            hist_scales[n] = max(absmax.get(n, 0.0), OBSERVER_MIN_SCALE) / bins
            ranges2[n] = np.float32(hist_scales[n])
        run2 = 0.0
        acc2 = None
        for feed in feeds:
            t0 = time.perf_counter()
            _, stats = fn(params, feed, ranges2)
            acc2 = fold(acc2, stats)
            run2 += time.perf_counter() - t0
        t0 = time.perf_counter()
        acc2 = self._reduce(acc2, kinds, sweep=2)
        hists = {n: _host(acc2[n][1]) for n in twophase if n in (acc2 or {})}
        run2 += time.perf_counter() - t0

        t0 = time.perf_counter()
        for name in twophase:
            if name not in hists:
                continue
            clips = {}      # one search a bit width: roots may differ in it
            for cfg in roots[name]:
                levels = 1 << (cfg.num_of_bits - 1)
                if levels not in clips:
                    if algo_of[name] == 'kl':
                        best_bin = kl_threshold_search(hists[name], levels)
                    else:
                        best_bin = mse_threshold_search(
                            hists[name], hist_scales[name], levels)
                    clips[levels] = (best_bin + 0.5) * hist_scales[name]
                clip = clips[levels]
                self._activate(cfg, *minmax_to_scale_offset(
                    np.asarray(-clip), np.asarray(clip), cfg))
        LAST_CALIBRATION_PROFILE['run2_s'] = run2
        LAST_CALIBRATION_PROFILE['search_s'] = time.perf_counter() - t0

    @staticmethod
    def _activate(cfg: TensorQuantizationConfig, scale, offset):
        cfg.scale = scale
        cfg.offset = offset
        if cfg.state == QuantizationStates.INITIAL:
            cfg.state = QuantizationStates.ACTIVATED
        elif cfg.state == QuantizationStates.PASSIVE_INIT:
            cfg.state = QuantizationStates.PASSIVE
