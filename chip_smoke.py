"""Drive the PyTorch port's main path on one NVIDIA card and hold every CUDA
kernel on it against its plain PyTorch version.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):
  1. card: name, and `nvidia-smi` name and power limit;
  2. build: nvcc builds every kernel of ppq_tpu_torch/csrc for sm_90a;
  3. kernels: each kernel against its plain version at the main path's
     shapes (fake-quant bit for bit under all rounding policies, histogram
     counts exactly), with kernel, plain and library times and the bound;
  4. main path: zoo ResNet-18 at full width, `quantize_graph` with TPU_INT8
     over 16 seeded batches of 32 (percentile), a second quantization with
     KL over 4 batches, and the simulated forward at batch 32; the forward
     equals one whose fake-quant runs the plain versions, and its SNR
     against the fp32 forward is reported;
  5. launches: every kernel ran on the main path; then a torch.profiler
     breakdown of the forward's device time (not part of the counts).
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
REPEATS = 30
CALIB_BATCH, CALIB_STEPS, KL_STEPS, IMAGE = 32, 16, 4, 224

KERNELS = {
    'fake_quant_tensorwise': ('ppq_tpu_torch/csrc/fake_quant.cu',
                              'ppq_tpu/kernels/quant.py:115'),
    'fake_quant_channelwise': ('ppq_tpu_torch/csrc/fake_quant.cu',
                               'ppq_tpu/kernels/quant.py:251'),
    'histogram': ('ppq_tpu_torch/csrc/histogram.cu',
                  'ppq_tpu/kernels/histogram.py:61'),
}


def log(*args):
    print(*args, flush=True)


def time_ms(fn, flush) -> float:
    """Median of REPEATS launches timed with CUDA events, the L2 cache
    flushed before each, as the main path finds these tensors cold. The
    flush (512 MB written, ~0.2 ms) keeps the card busy while the host
    enqueues the call, so the host's own overhead stays out of the window."""
    fn()
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(bytes_moved: float, ops: float):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops, 'operations')


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA card visible')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f'[card] {name}; torch {torch.__version__} cuda {torch.version.cuda}')
    log(smi)
    return name, smi


def phase_build():
    from ppq_tpu_torch.kernels import loader as kbuild
    t0 = time.perf_counter()
    seconds = kbuild.build()
    log(f'[build] {time.perf_counter() - t0:.2f} s wall, per library '
        f'{json.dumps({k: round(v, 2) for k, v in seconds.items()})}')
    for name, out in kbuild.BUILD_LOG.items():
        lines = {line.strip() for line in out.splitlines()
                 if 'registers' in line or 'spill' in line}
        for line in sorted(lines):
            log(f'[ptxas {name}] {line}')


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    from ppq_tpu_torch.core import RoundingPolicy
    from ppq_tpu_torch.kernels import (histogram, histogram_plain,
                                       linear_quant, linear_quant_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    act = torch.randn(32, 64, 112, 112, device=dev, generator=gen) * 2.0
    weight = torch.randn(512, 512, 3, 3, device=dev, generator=gen) * 0.05
    n_act, n_w = act.numel(), weight.numel()
    s_act = 0.0371
    s_w = (torch.rand(512, device=dev, generator=gen) * 0.002 + 0.0005).cpu().numpy()
    z_w = np.zeros(512, np.float32)
    results = {}

    err = 0.0
    for policy in RoundingPolicy:
        for s, o, lo, hi in ((s_act, 0.0, -128, 127), (s_act, 3.4, 0, 255)):
            got = linear_quant(act, s, o, lo, hi, policy)
            want = linear_quant_plain(act, s, o, lo, hi, policy)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f'fake_quant_tensorwise != plain ({policy.name})')
            err = max(err, float((got - want).abs().max()))
    ms = time_ms(lambda: linear_quant(act, s_act, 0.0, -128, 127), flush)
    plain = time_ms(lambda: linear_quant_plain(act, s_act, 0.0, -128, 127), flush)
    lib = time_ms(lambda: torch.fake_quantize_per_tensor_affine(
        act, s_act, 0, -128, 127), flush)
    b, by = bound_ms(8.0 * n_act, 7.0 * n_act)
    results['fake_quant_tensorwise'] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                            library_ms=lib, bound_ms=b, bound_by=by,
                                            shape=list(act.shape))

    err = 0.0
    for policy in RoundingPolicy:
        got = linear_quant(weight, s_w, z_w, -128, 127, policy, 0)
        want = linear_quant_plain(weight, s_w, z_w, -128, 127, policy, 0)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f'fake_quant_channelwise != plain ({policy.name})')
        err = max(err, float((got - want).abs().max()))
    # timed with the scales and offsets already on the card (the wrapper
    # still rounds the offsets: one more small launch in the window)
    s_w_t = torch.as_tensor(s_w, device=dev)
    o_w_t = torch.as_tensor(z_w, device=dev)
    z_w_t = torch.zeros(512, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: linear_quant(weight, s_w_t, o_w_t, -128, 127,
                                      RoundingPolicy.ROUND_HALF_EVEN, 0), flush)
    plain = time_ms(lambda: linear_quant_plain(weight, s_w_t, o_w_t, -128, 127,
                                               RoundingPolicy.ROUND_HALF_EVEN, 0),
                    flush)
    lib = time_ms(lambda: torch.fake_quantize_per_channel_affine(
        weight, s_w_t, z_w_t, 0, -128, 127), flush)
    b, by = bound_ms(8.0 * n_w + 8.0 * 512, 7.0 * n_w)
    results['fake_quant_channelwise'] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                             library_ms=lib, bound_ms=b, bound_by=by,
                                             shape=list(weight.shape))

    post_relu = torch.relu(act)
    err = 0.0
    timed = {}
    for bins in (4096, 2048):
        scale = float(post_relu.max()) / bins
        for x, absolute in ((post_relu, True), (act, True), (act, False)):
            got = histogram(x, scale, bins, absolute=absolute)
            want = histogram_plain(x, scale, bins, absolute=absolute)
            if not torch.equal(got, want):
                raise AssertionError(f'histogram != plain ({bins} bins, '
                                     f'absolute={absolute})')
            if int(got.sum()) != x.numel():
                raise AssertionError('histogram lost counts')
        idx = torch.clamp(post_relu / scale, 0, bins - 1).to(torch.int64).reshape(-1)
        timed[bins] = dict(
            ms=time_ms(lambda: histogram(post_relu, scale, bins), flush),
            plain_ms=time_ms(lambda: histogram_plain(post_relu, scale, bins), flush),
            # yardstick, two calls: the clipped bin indices, then bincount
            library_ms=(time_ms(lambda: torch.clamp(post_relu / scale, 0, bins - 1)
                                .to(torch.int64).reshape(-1), flush)
                        + time_ms(lambda: torch.bincount(idx, minlength=bins), flush)))
    b, by = bound_ms(4.0 * n_act + 8.0 * 4096, 3.0 * n_act)
    results['histogram'] = dict(max_abs_err=err, bound_ms=b, bound_by=by,
                                shape=list(act.shape), bins=4096, **timed[4096],
                                bins_2048=timed[2048])
    for name, r in results.items():
        log(f'[kernel] {name} {r["shape"]}: {r["ms"]:.4f} ms, plain '
            f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms, bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}), share of bound '
            f'{r["bound_ms"] / r["ms"]:.3f}')
    log(f'[kernel] histogram 2048 bins: {json.dumps(results["histogram"]["bins_2048"])}')
    del act, weight, post_relu, flush
    torch.cuda.empty_cache()
    return results


def _plain_delegate(tensor, cfg):
    """Fake-quant through the kernels' plain versions (ppq_fake_quant's
    argument handling, the plain arithmetic)."""
    from ppq_tpu_torch.kernels import linear_quant_plain
    if not isinstance(tensor, torch.Tensor) or not tensor.is_floating_point() \
            or not cfg.is_active:
        return tensor
    scale = np.asarray(cfg.scale, np.float32)
    offset = (np.asarray(cfg.offset, np.float32) if cfg.policy.asymmetric
              else np.zeros_like(scale))
    axis = cfg.channel_axis if cfg.policy.per_channel else None
    return linear_quant_plain(tensor, scale, offset, cfg.quant_min,
                              cfg.quant_max, cfg.rounding, axis)


def phase_main_path(dev):
    from ppq_tpu_torch import (DEQUANTIZE_GRAPH, TargetPlatform, TorchExecutor,
                               quantize_graph)
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    from ppq_tpu_torch.zoo import resnet18

    # the kernel path and the plain path must be comparable bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    shape = [CALIB_BATCH, 3, IMAGE, IMAGE]
    rng = np.random.RandomState(0)
    loader = [rng.randn(*shape).astype(np.float32) for _ in range(CALIB_STEPS)]
    x_eval = np.random.RandomState(1).randn(*shape).astype(np.float32)

    reset_launches()
    graph = resnet18(input_shape=shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_graph(graph, loader, calib_steps=CALIB_STEPS,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    after_pct = dict(LAUNCHES)

    kl_graph = resnet18(input_shape=shape)
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation_setting.calib_algorithm = 'kl'
    t0 = time.perf_counter()
    quantize_graph(kl_graph, loader[:KL_STEPS], calib_steps=KL_STEPS,
                   platform=TargetPlatform.TPU_INT8, setting=setting,
                   verbose=False)
    torch.cuda.synchronize()
    kl_s = time.perf_counter() - t0
    after_kl = dict(LAUNCHES)

    executor = TorchExecutor(graph)
    x_dev = torch.as_tensor(x_eval, device=dev)
    y = executor.forward(x_dev)[0]
    torch.cuda.synchronize()
    before_fwd = dict(LAUNCHES)
    n_fwd = 10
    t0 = time.perf_counter()
    for _ in range(n_fwd):
        y = executor.forward(x_dev)[0]
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / n_fwd
    after_fwd = dict(LAUNCHES)
    y_kl = TorchExecutor(kl_graph).forward(x_dev)[0]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    phase_profile(executor, x_dev)

    # the tracing forward of quantize_graph applies no fake-quant; a KL
    # calibration runs two sweeps (abs-max, then histogram)
    per_forward = {k: (after_fwd[k] - before_fwd[k]) / n_fwd for k in launches}
    per_calib_batch = {k: after_pct[k] / CALIB_STEPS for k in launches}
    per_kl_batch = {k: (after_kl[k] - after_pct[k]) / KL_STEPS
                    for k in launches}

    # comparisons: these launches are not the main path's
    plain_exec = TorchExecutor(graph)
    for op in graph.operations.values():
        if hasattr(op, 'config'):
            for cfg in op.config:
                plain_exec.register_quantize_delegate(cfg, _plain_delegate)
    y_plain = plain_exec.forward(x_dev)[0]
    with DEQUANTIZE_GRAPH(graph):
        y_fp32 = TorchExecutor(graph).forward(x_dev)[0]
    with DEQUANTIZE_GRAPH(kl_graph):
        y_kl_fp32 = TorchExecutor(kl_graph).forward(x_dev)[0]

    for name, out in (('percentile', y), ('kl', y_kl), ('fp32', y_fp32)):
        if tuple(out.shape) != (CALIB_BATCH, 1000) or not torch.isfinite(out).all():
            raise AssertionError(f'{name} forward: shape {tuple(out.shape)}, '
                                 f'finite {bool(torch.isfinite(out).all())}')
    if not torch.equal(y, y_plain):
        raise AssertionError('kernel-path forward != plain-path forward '
                             f'(max |diff| {float((y - y_plain).abs().max())})')
    snr = float(torch_snr_error(y, y_fp32))
    snr_kl = float(torch_snr_error(y_kl, y_kl_fp32))
    top1 = float((y.argmax(-1) == y_fp32.argmax(-1)).float().mean())
    top1_kl = float((y_kl.argmax(-1) == y_kl_fp32.argmax(-1)).float().mean())
    # int8 fake-quant of a 21-layer net: noise far below the signal (the
    # first full-width H100 run measured 5.3e-4 and 5.4e-4)
    if not (snr < 1e-2 and snr_kl < 1e-2):
        raise AssertionError(f'quantized forward SNR too large: {snr}, {snr_kl}')
    summary = dict(
        calibration_percentile_s=cal_s,
        calibration_percentile_img_per_s=CALIB_BATCH * CALIB_STEPS / cal_s,
        calibration_kl_s=kl_s,
        calibration_kl_img_per_s=CALIB_BATCH * KL_STEPS / kl_s,
        forward_ms=fwd_s * 1e3, forward_img_per_s=CALIB_BATCH / fwd_s,
        snr_percentile=snr, top1_agree_percentile=top1,
        snr_kl=snr_kl, top1_agree_kl=top1_kl, plain_path_equal=True,
        launches_per_forward=per_forward,
        launches_per_percentile_calib_batch=per_calib_batch,
        launches_per_kl_calib_batch_both_sweeps=per_kl_batch,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f'[main] {json.dumps(summary)}')
    return launches, summary


def phase_profile(executor, x_dev, n=3):
    """Where the simulated forward's device time goes: torch.profiler over
    n forwards, device time by kernel name and the device's busy share of
    the wall time. Runs after the launch counts are read, on the graph as
    quantize_graph left it (DEQUANTIZE_GRAPH would un-bake the weights)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            executor.forward(x_dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): an op's row repeats the
    # time of the kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in rows)
    if not rows:
        log('[profile] the profiler recorded no device time: not measured')
        return
    log(f'[profile] {n} forwards: wall {wall_us / n / 1e3:.3f} ms/forward, '
        f'device busy {busy_us / n / 1e3:.3f} ms/forward, busy share '
        f'{busy_us / wall_us:.3f}')
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f'[profile]   {t / n / 1e3:8.3f} ms/forward  {count // n:4d} calls  '
            f'{key[:90]}')


def main() -> int:
    t_start = time.perf_counter()
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build()
    kernel_results = phase_kernels(dev)
    launches, summary = phase_main_path(dev)
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the main path: {missing}')
    line = {'kernels': [
        {'name': k, 'route': 'cuda', 'source': KERNELS[k][0],
         'replaces': KERNELS[k][1], 'launches': launches[k],
         'max_abs_err': kernel_results[k]['max_abs_err'],
         'ms': kernel_results[k]['ms'], 'plain_ms': kernel_results[k]['plain_ms'],
         'bound_ms': kernel_results[k]['bound_ms'],
         'bound_by': kernel_results[k]['bound_by'],
         'library_ms': kernel_results[k]['library_ms']} for k in KERNELS]}
    log(f'[done] {time.perf_counter() - t_start:.1f} s; {smi}')
    log(json.dumps(line))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
