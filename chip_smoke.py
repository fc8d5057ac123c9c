"""Drive the PyTorch port's paths on one NVIDIA card and hold every CUDA
kernel on them against its plain PyTorch version.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):
  1. card: name, and `nvidia-smi` name and power limit;
  2. build: nvcc builds every kernel of ppq_tpu_torch/csrc for sm_90a;
  3. kernels: each kernel against its plain version at the paths' shapes
     (fake-quant forward, its `dx` and the floating fake-quant bit for bit,
     the LSQ sums against a float64 sum of the plain terms and run to run
     exactly, histogram counts exactly, the dequant-matmuls within 1e-5 of
     the row's absolute mass, the KV and pool writes bit for bit, the paged
     reads within the attention tolerance), with kernel, plain and library
     times and the bound;
  4. path A: zoo ResNet-18 at full width, `quantize_graph` with TPU_INT8
     over 16 seeded batches of 32 (percentile), a second quantization with
     KL over 4 batches, both through the observer path, and the simulated
     forward at batch 32; the forward equals one whose fake-quant runs the
     plain versions, and its SNR against the fp32 forward is reported;
 4b. path H: the same quantizations through the default, compiled
     calibration (one CUDA graph a batch; the KL searches in the native
     library), then `stem_space_to_depth` and `compile_graph(precision=
     'int' | 'highest' | 'bf16').make_runner(chain=4)` at batch 256, one
     CUDA graph a chain: img/s, busy share, device events and launches of
     a replay, peak memory; then the scales against path A's, the 'int'
     sums against int64, the card's 'int' logits against the CPU's, replays
     against the uncaptured walk and chain-1 replays, rows 1-3 inside
     captures against their plain versions, 'int' against 'highest' and
     the fp32 model (`--compiled` runs this path alone);
 4c. path I: ingest and export at the same width: the seeded zoo graph
     written to ONNX and parsed back (parameters bit for bit),
     `quantize_onnx_model` on the file (its TQCs and 'int' logits at batch
     256 bit for bit those of `quantize_graph` on the zoo graph),
     `export_ppq_graph` to TPU_INT8 and TRT_INT8 QDQ, TensorRT's JSON
     ranges, NCNN_INT8's table and a native checkpoint, the QDQ file
     parsed and run on the card (eager at batch 32, a 'highest' runner at
     256) against the simulation, the checkpoint's 'int' logits bit for
     bit, QuantizeLinear's kernel against its plain twin, and a
     ResNet-18-shaped torch.nn.Module through `load_torch_model` against
     its own forward (`--frontends` runs this path alone);
  4d. path J: the op library and the zoo beyond ResNet: every case of
     tests/torch_op_cases.py (every op type and the NXP Resize) on the card
     against the CPU; BERT-base at full width (12 layers, d_model 768, 12
     heads, FFN 3072, 128 tokens, batch 32) through `quantize_graph` with
     TPU_INT8 (percentile over 16 batches, compiled calibration; KL over
     4), the eager forward, the 'int' / 'highest' / 'bf16' runners in
     chains of 4, TPU_FP8 (E4M3); the other twelve zoo graphs quantized,
     run eagerly and as 'highest' runners; then SNRs against fp32, int64
     sums, the card's 'int' against the CPU's, replays against the walk,
     the launches of a forward and of a replay site by site
     (`--ops` runs this path alone; `--fp8-sample` runs path C's and
     BERT-base's FP8 calibration under the port's DirectMSE sample and
     the JAX package's);
  4e. path K: the other passes, the analyses and the evaluation harnesses
     at full width: BASELINE.json's MobileNetV2 configuration (width 1.0,
     batch 32 at 224², TPU_INT8 per-channel, KL over 4, BiasCorrection,
     LayerwiseEqualization) and the same without equalization, SNR and
     top-1 against fp32; equalization alone against the fp32 output, the
     card's uploaded weights against the host and the same pass on the
     CPU; on ResNet-18 SSD equalization, channel split and horizontal layer
     split (each alone against fp32, then through `quantize_graph`),
     LearningToCalibPass and MatrixFactorizationPass; graphwise, layerwise,
     statistical and parameter analyses (compiled against eager, seconds,
     peak memory); `evaluate_classification` compiled against eager;
     `quantzoo_benchmark` over ResNet-18 and MobileNetV2 x its three
     schemes (`--passes` runs this path alone);
  4f. path N: the rest of the single-card surface at the same width: each
     of the 23 platforms of QUANTIZER_COLLECTION quantizes ResNet-18
     (batch 32, 4 seeded batches; SNR and top-1 against fp32 bounded per
     kind), and every TQC of each against a child process's CPU run on 2
     batches of 8 (`--api-cpu-reference`); PFL's ParameterQuant and
     QuantFunction on the 20 conv weights (FP8 per channel: row 6's
     channelwise body; power-of-2; asymmetric) bit for bit against the
     plain versions; a QConv2d / QLinear stack at ResNet-18's conv shapes
     calibrated on 4 batches, one step held against the plain versions,
     then 20 SGD steps whose loss falls; the TPU_INT8 graph's 'highest'
     forward exported with torch.export, reloaded and held bit for bit
     against the runner, `benchmark_graph` at 1 / 32 / 256 and
     `profile_graph`; 16 seeded `.npy` batches through the native loader
     into `quantize_graph`, the scales equal to the same batches from
     memory (`--api` runs this path alone);
 5. path B: the same model, `quantize_graph` with `lsq_optimization` (LSQ
     over every block, weights and scales trained, 4 cached batches; every
     step after a block's first a CUDA-graph replay), the forward and its
     SNR against the fp32 model before and after LSQ; then
     BiasCorrectionPass and RoundTuningPass through `manop` on quantized
     graphs; outside the counts, LSQ, BiasCorrection and RoundTuning with
     their steps captured against the same passes uncaptured, bit for bit
     (trained tensors, Adam's state, decisions, the graph afterwards);
  6. path C: `quantize_graph` with TPU_FP8 and `fp8_setting`, the forward
     (equal to the plain path), then LearnedStepSizePass with frozen scales
     through `manop` (captured against uncaptured outside the counts);
  7. path D: the serving engine at the full width of the 1B Llama-class
     model (16 layers, d_model 2048, INT8 weights, INT8 KV cache, 128
     slots) with the dense cache read (`use_ragged_attention=False`): `run`
     over 160 seeded requests in two waves, with a chunked prefill, eos
     stops and per-request sampling; `benchmark_decode` at fill 16 and 512,
     its bursts captured as CUDA graphs (the engine's default on a card)
     and uncaptured; then, outside the counts, one burst as a replay
     against the same burst uncaptured, bit for bit (tokens and cache;
     greedy and sampled, from one generator state), a burst against the
     same steps taken one by one, the kernel path against the plain
     versions, and torch.profiler windows over one burst, captured and
     uncaptured (paths E, F and G do the same);
  8. path E: the engine's default configuration on the first 8 of the
     same weights' 16 layers (CUT_LAYERS; widths unchanged): the ragged
     read through the paged-attention kernels (grouped at fill 16,
     per slot at fill 512), `run` and `benchmark_decode` as in D; then the
     ragged burst against D's dense burst, the kernel path against the plain
     path, every launch against its plain version, the profile and the
     window repack's device time;
  9. path G: path D's model with the paged KV cache (`paged_kv=True`,
     blocks of 256, the default pool of 513 blocks): `run` over the same
     160 requests with every block back at its start, `benchmark_decode` at
     fill 16 and 512 with the window repack's time, and one burst at each
     fill on which row 13 reads every layer's inputs at one step (held
     against its plain version and the engine's composition); then,
     outside the counts, a prefix-cache run (32 requests sharing a 512-token
     prefix) against the same requests with the cache off, the paged burst
     against path E's ragged burst on the same prompt KV, the kernel path
     against the plain path, every launch against its plain version and the
     profile; its engine runs the native block allocator
     (PPQ_TPU_NATIVE_ALLOC=1; the port's default is the Python list), every
     call its `run` made is replayed on the Python free list with the same
     results, and both backends are timed on those calls;
 10. path F: INT4 weights (an INT8 lm_head), ragged read, 128 slots, 8
     of the 16 layers:
     `benchmark_decode` at fill 16 and 512, a short `run`, the kernel path
     against the plain path and every launch against its plain version;
 10b. path L: bench.py's serving track at its widths (`bench.py:396-499`):
     path G's engine on the first 8 of path D's 16 layers,
     `benchmark_serving(192, 64, 128,
     sync_every=128)` through the planned loop (its timed run under
     torch.cuda.set_sync_debug_mode('error') from its first dispatch to its
     download, with no capture in it), its tokens against the synchronous
     loop's, `benchmark_serving_mixed(192, 64, 96, sync_every=32)`, the
     open-loop sweep at 0.6 / 0.8 / 0.95 of the mixed requests/s, every
     block back after each, and the B=32 decode points, INT4 and INT8
     (`--serving` runs this path alone);
 10c. path M: the LLM quantization path at the full width of bench.py's
     1B decoder, 8 of its 16 layers (`init_llama_params(quantized=False,
     seed=0)`): AWQ and
     GPTQ INT4 and SmoothQuant W8A8 on the card beside round-to-nearest
     (seconds, peak memory, logits SNR against the float model), each of
     the three served (`run`, `benchmark_decode` at fill 16 captured, 32
     slots; W8A8 launches no row 10, INT4 rows 9 and 10), the W8A8 int32
     sums against int64, a MoE engine (8 experts top-2, 2 layers) and its
     moe_ffn against the CPU, speculative decoding (k 4, a seeded 2-layer
     draft and the target itself) against plain greedy, and AWQ / GPTQ on
     the card against a child process's CPU run at 2 layers (`--llm` runs
     this path alone);
 10d. path O: the parallel layer (ppq_tpu_torch/parallel, ring attention,
     GPipe, tensor-parallel serving) on a world of four ranks that share
     the card (parallel.spawn; gloo, every collective staged through host
     memory): O1 ResNet-18's compiled calibration over dp 2 (percentile
     and KL, 4 batches of 32 at 224²), O2 the dp 2 x tp 2 sharded step (3
     steps towards the fp32 outputs), O3 ring attention over sp 2 and 4 at
     the 1B decoder's heads (T 4096, bf16, causal and full), O4 the GPipe
     forward over pp 2 of its 16 layers, O5 its tp-2 engines (INT8 dense,
     ragged, paged; INT4: `run` over 32 requests, benchmark_decode for 8
     steps at fill 16 and 512), O6 the dp 2 x tp 2 paged engine, O7 path
     M's MoE engine at ep 2, O8-O13 the pipeline and sequence legs (dense
     pp 2 and sp 2; paged pp 2, sp 2 x tp 2, dp 2 x sp 2 with the grouped
     prefix cache, pp 2 x sp 2: `run` on prompts that cross a shard's
     positions or blocks, benchmark_decode for 4 steps at fill 16 and 512,
     no fault bit, each rank's decode launches one card's); each held
     against the same computation on one card in this process, every
     rank's tokens equal; the seconds and ms a step of ranks sharing one
     card are correctness figures, not scaling figures (`--parallel` runs
     this path alone);
 11. launches: every kernel ran on a path (the counts are set to 0 before
     each path and read after it); then, outside the counts, the time and
     the launches of an LSQ step, captured and uncaptured, block by block
     on the INT8 and the FP8 graph, and torch.profiler breakdowns of the
     forward and of the first block's LSQ steps.
The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
REPEATS = 30
SPIN_CYCLES_PER_S = 1.98e9     # H100 SXM's highest SM clock: a spin of
                               # torch.cuda._sleep lasts at least its time
CALIB_BATCH, CALIB_STEPS, KL_STEPS, IMAGE = 32, 16, 4, 224
TRAIN_BATCHES, LSQ_STEPS, ROUND_STEPS = 4, 16, 8
# steps of the captured-against-uncaptured runs of paths B and C
CAPTURE_STEPS = 6
# smoke bounds on the output's noise-to-signal ratio against the fp32
# model: int8 fake-quant of a 21-layer net measured 5.3e-4 at full width;
# E4M3 keeps 3 mantissa bits at each of 42 quant sites and measured 4.5e-3
# (0.150 where DirectMSE sampled at the JAX package's stride, which reads
# one column of most activations: ROADMAP.md queue 3 item 36).
# Finetuning must not worsen either (5 % for blocks tuned one by one).
SNR_INT8_BOUND, SNR_FP8_BOUND = 1e-2, 2e-2
# the kernels' shapes: the largest activation of the paths (the first ReLU's
# output) and the largest conv weight, quantized along axis 0
ACT_SHAPE, WEIGHT_SHAPE = (32, 64, 112, 112), (512, 512, 3, 3)

KERNELS = {
    'fake_quant_tensorwise': ('ppq_tpu_torch/csrc/fake_quant.cu',
                              'ppq_tpu/kernels/quant.py:115'),
    'fake_quant_channelwise': ('ppq_tpu_torch/csrc/fake_quant.cu',
                               'ppq_tpu/kernels/quant.py:251'),
    'histogram': ('ppq_tpu_torch/csrc/histogram.cu',
                  'ppq_tpu/kernels/histogram.py:61'),
    'fake_quant_bwd_tensorwise': ('ppq_tpu_torch/csrc/fake_quant_bwd.cu',
                                  'ppq_tpu/kernels/quant.py:149'),
    'fake_quant_bwd_channelwise': ('ppq_tpu_torch/csrc/fake_quant_bwd.cu',
                                   'ppq_tpu/kernels/quant.py:280'),
    # both bodies: floating.py:83 (channelwise) and :101 (tensorwise)
    'floating_quant': ('ppq_tpu_torch/csrc/floating.cu',
                       'ppq_tpu/kernels/floating.py:101'),
    'floating_quant_bwd': ('ppq_tpu_torch/csrc/floating.cu',
                           'ppq_tpu/kernels/floating.py:126'),
    'qmm_int8': ('ppq_tpu_torch/csrc/qmm.cu', 'ppq_tpu/kernels/qmm.py:142'),
    'qmm_int4': ('ppq_tpu_torch/csrc/qmm.cu', 'ppq_tpu/kernels/qmm.py:249'),
    # the INT8 body and the INT4 body of one TPU kernel
    'qmm_gateup': ('ppq_tpu_torch/csrc/qmm.cu', 'ppq_tpu/kernels/qmm.py:351'),
    'qmm_gateup_int4': ('ppq_tpu_torch/csrc/qmm.cu',
                        'ppq_tpu/kernels/qmm.py:351'),
    'paged_attention_fused': ('ppq_tpu_torch/csrc/paged_attention.cu',
                              'ppq_tpu/kernels/paged_attention.py:323'),
    'paged_attention_grouped': ('ppq_tpu_torch/csrc/paged_attention.cu',
                                'ppq_tpu/kernels/paged_attention.py:629'),
    'bank_write': ('ppq_tpu_torch/csrc/kv_write.cu',
                   'ppq_tpu/kernels/bank_write.py:81'),
    'window_write': ('ppq_tpu_torch/csrc/kv_write.cu',
                     'ppq_tpu/kernels/window_write.py:97'),
    'paged_attention_buffered': ('ppq_tpu_torch/csrc/paged_attention.cu',
                                 'ppq_tpu/kernels/paged_attention.py:858'),
    'pool_write': ('ppq_tpu_torch/csrc/kv_write.cu',
                   'ppq_tpu/kernels/pool_write.py:156'),
}

# path D: the model bench.py serves, at full width and depth
SERVE = dict(d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8, d_ff=5632,
             vocab_size=32000, max_seq_len=1024, max_batch=128,
             weight_bits=8, kv_cache_bits=8, prefill_buckets=(128,))
SERVE_REQUESTS, SERVE_SYNC, BURST = 160, 16, 32
# Paths E, F, L and M run the first CUT_LAYERS of the decoder's 16 layers,
# every width unchanged; D, G and O keep the 16. With every path at 16 the
# full smoke read 1131 s of its 1200 on an H100 (700 W), and 1053 s with
# only M at 8 and L's requests and windows cut
CUT_LAYERS = 8
CUT_SERVE = dict(SERVE, n_layers=CUT_LAYERS)


def _first_layers(params):
    """A parameter tree's first CUT_LAYERS layers (the tensors shared)."""
    return dict(params, layers=params['layers'][:CUT_LAYERS])
# Kernel path against plain path, and burst against single steps, teacher-
# forced with the same tokens. Both sides multiply the same bf16 operands and
# sum in f32 in another order, so some of a matmul's outputs round to the
# neighbouring bf16 number; the residual stream carries that on, and the next
# layers' K and V move by a fraction of a code. Measured on an H100 at full
# width: the first layer's KV codes differ on 6e-5 of entries (its inputs are
# identical: this is the kernels' own share), the 16th layer's on 0.40
# (kernel against plain, at most 4 codes) and 0.057 (burst against steps, at
# most 3); logits within 1.3e-2 of the largest |logit|. The limits: logits
# 3e-2; no argmax flip where the top-1 margin exceeds that; KV codes 1e-3 of
# entries in the first layer; in any layer 0.5 by at most 6 codes (kernel
# against plain) and 0.1 by at most 4 (burst against steps). That the later
# layers' share is carried and not made there is held by _ShadowKernels:
# every launch of the real path against its plain version on that launch's
# own inputs, where every layer must stay within the first layer's limit.
SERVE_LOGIT_TOL, SERVE_CODE_SHARE_FIRST = 3e-2, 1e-3
SERVE_KERNEL_VS_PLAIN = dict(code_share=0.5, code_step=6)
SERVE_BURST_VS_STEPS = dict(code_share=0.1, code_step=4)
# path E holds the ragged read against the dense read under the kernel-vs-
# plain limits: both attend over the same codes, but p rounds to bf16
# against the running block max in one and as a normalised probability in
# the other, which is the same order of bf16 noise
SERVE_RAGGED_VS_DENSE = SERVE_KERNEL_VS_PLAIN
# path F's run: fewer requests (its decode is timed by benchmark_decode)
INT4_REQUESTS = 48
# the serving kernels of each path, and nothing else
PATH_KERNELS = {
    'D': ('qmm_int8', 'qmm_gateup', 'bank_write', 'window_write'),
    'E': ('qmm_int8', 'qmm_gateup', 'bank_write', 'window_write',
          'paged_attention_fused', 'paged_attention_grouped'),
    'F': ('qmm_int8', 'qmm_int4', 'qmm_gateup_int4', 'bank_write',
          'window_write', 'paged_attention_fused', 'paged_attention_grouped'),
    # row 13 is not the engine's: path G launches it on its bursts' inputs
    'G': ('qmm_int8', 'qmm_gateup', 'bank_write', 'pool_write',
          'paged_attention_grouped', 'paged_attention_buffered'),
    # the AWQ / GPTQ INT4, SmoothQuant W8A8 and MoE engines (ragged read)
    'M': ('qmm_int8', 'qmm_int4', 'qmm_gateup_int4', 'bank_write',
          'window_write', 'paged_attention_grouped'),
    # the paged engine, then the dense B=32 points at fill 16, INT4 and INT8
    'L': ('qmm_int8', 'qmm_gateup', 'qmm_int4', 'qmm_gateup_int4',
          'bank_write', 'pool_write', 'window_write',
          'paged_attention_grouped'),
}
# path N: the quantization kernels (rows 1-6), and no serving kernel
PATH_KERNELS['N'] = ('fake_quant_tensorwise', 'fake_quant_channelwise',
                     'histogram', 'fake_quant_bwd_tensorwise',
                     'fake_quant_bwd_channelwise', 'floating_quant')
PATH_MAY_LAUNCH = {'M': ('paged_attention_fused',)}
# path L: bench.py's serving track (`bench.py:396-499`) on path G's engine;
# the open-loop sweep's windows, cut from bench.py's 22 s to fit the smoke
SWEEP_S = 6.0
SERVING_KEYS = {
    'benchmark_serving': ('requests_per_sec', 'generated_tokens_per_sec',
                          'total_tokens_per_sec', 'wall_s'),
    'benchmark_serving_mixed': ('requests_per_sec', 'generated_tokens_per_sec',
                                'total_tokens_per_sec', 'wall_s',
                                'ttft_p50_ms', 'ttft_p99_ms', 'tpot_p50_ms',
                                'tpot_p99_ms')}
# path G: path D's model with the paged KV cache (bench.py's paged
# configuration: blocks of 256, the default pool of 128 * 1024 / 256 + 1
# blocks); its prefix-cache run: 32 requests sharing a 512-token prefix
PAGED_PREFIX, PAGED_PREFIX_REQUESTS, PAGED_PREFIX_BLOCKS = 512, 32, 64


def log(*args):
    print(*args, flush=True)


def _host_ms(fn, calls=5) -> float:
    """The host's median time to enqueue fn, the card idle before each
    call."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _event_times(fn, flush, pad_ms):
    """REPEATS timings of fn with CUDA events, the L2 cache flushed before
    each, and after the flush the card held busy by a spin of pad_ms."""
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        if pad_ms:
            torch.cuda._sleep(int(pad_ms * 1e-3 * SPIN_CYCLES_PER_S))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, flush) -> float:
    """Median of REPEATS launches timed with CUDA events, the L2 cache
    flushed before each, as the main path finds these tensors cold. After
    the flush (512 MB written, ~0.17 ms) the card spins for twice the
    host's time to enqueue fn, so every launch of fn is queued before the
    start event is reached and the window holds the card's time alone. (A
    flush alone left it to chance: row 5's wrapper takes 0.08-0.11 ms of
    host time, up to 0.16, and some of the 30 windows held an idle card
    waiting for the launch: medians of 0.026-0.062 ms for a kernel of
    0.0255.)"""
    fn()
    pad = 2 * _host_ms(fn)
    return statistics.median(_event_times(fn, flush, pad))


def _clocks() -> str:
    """The card's SM and memory clocks and power draw, as nvidia-smi reads
    them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.mem,power.draw',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _timing_probe(label, fn, flush):
    """What time_ms's median of `fn` is made of, logged beside it: the
    card's clocks and power before and after, the host's time to enqueue
    one call, and the timings without the spin after the flush, with
    time_ms's spin (twice the host's time) and with spins of 0.5 and 2 ms
    (does the card's idle time after the flush change the kernel's?)."""
    before = _clocks()
    host = _host_ms(fn, REPEATS)
    timed = {'no spin': _event_times(fn, flush, 0),
             'spin (time_ms)': _event_times(fn, flush, 2 * host),
             'spin 0.5 ms': _event_times(fn, flush, 0.5),
             'spin 2 ms': _event_times(fn, flush, 2.0)}
    out = dict(clocks_before=before, clocks_after=_clocks(),
               host_enqueue_ms=host,
               **{f'{k} median_ms': statistics.median(v) for k, v in timed.items()},
               **{f'{k} min_max_ms': [min(v), max(v)] for k, v in timed.items()})
    log(f'[timing] {label}: {json.dumps(out)}')
    return out


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
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


def phase_build(names=None):
    from ppq_tpu_torch.kernels import loader as kbuild
    t0 = time.perf_counter()
    seconds = kbuild.build(*([names] if names else []))
    log(f'[build] {time.perf_counter() - t0:.2f} s wall, per library '
        f'{json.dumps({k: round(v, 2) for k, v in seconds.items()})}')
    for name, out in kbuild.BUILD_LOG.items():
        # each kernel's registers and spills, under its (mangled) name, and
        # any warning that ptxas serialised a wgmma
        kernel = ''
        for line in out.splitlines():
            found = re.search(r"(?:Compiling entry function|Function "
                              r"properties for) '?([\w$]+)", line)
            if found:
                kernel = found.group(1)
            elif 'registers' in line or 'spill' in line or 'wgmma' in line:
                log(f'[ptxas {name}] {kernel}: {line.strip()}')


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    results = kernels_quant(dev, flush)
    torch.cuda.empty_cache()
    results.update(kernels_serving(dev, flush))
    results.update(kernels_int4(dev, flush))
    results.update(kernels_ragged(dev, flush))
    results.update(kernels_paged(dev, flush))
    _log_kernels(results)
    del flush
    torch.cuda.empty_cache()
    return results


def _log_kernels(results):
    for name, r in results.items():
        lib = ('none' if r['library_ms'] is None
               else f'{r["library_ms"]:.4f} ms')
        log(f'[kernel] {name} {r["shape"]}: {r["ms"]:.4f} ms, plain '
            f'{r["plain_ms"]:.4f} ms, library {lib}, bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}), share of bound '
            f'{r["bound_ms"] / r["ms"]:.3f}')
    log(f'[kernel] histogram 2048 bins: '
        f'{json.dumps(results["histogram"]["bins_2048"])}')


def kernels_quant(dev, flush):
    """Rows 1-7 against their plain versions at the headline shapes: the
    largest activation of the paths (the first ReLU's output) and the
    largest conv weight, quantized along axis 0."""
    from ppq_tpu_torch.core import RoundingPolicy
    from ppq_tpu_torch.kernels import (histogram, histogram_plain,
                                       linear_quant, linear_quant_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    act = torch.randn(*ACT_SHAPE, device=dev, generator=gen) * 2.0
    weight = torch.randn(*WEIGHT_SHAPE, device=dev, generator=gen) * 0.05
    n_act, n_w = act.numel(), weight.numel()
    s_act = 0.0371
    channels = WEIGHT_SHAPE[0]
    s_w = (torch.rand(channels, device=dev, generator=gen) * 0.002
           + 0.0005).cpu().numpy()
    z_w = np.zeros(channels, np.float32)
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
    # timed with the scales and offsets already on the card (the kernel
    # rounds the offsets)
    s_w_t = torch.as_tensor(s_w, device=dev)
    o_w_t = torch.as_tensor(z_w, device=dev)
    z_w_t = torch.zeros(channels, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: linear_quant(weight, s_w_t, o_w_t, -128, 127,
                                      RoundingPolicy.ROUND_HALF_EVEN, 0), flush)
    plain = time_ms(lambda: linear_quant_plain(weight, s_w_t, o_w_t, -128, 127,
                                               RoundingPolicy.ROUND_HALF_EVEN, 0),
                    flush)
    lib = time_ms(lambda: torch.fake_quantize_per_channel_affine(
        weight, s_w_t, z_w_t, 0, -128, 127), flush)
    b, by = bound_ms(8.0 * n_w + 8.0 * channels, 7.0 * n_w)
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
            err = max(err, float((got - want).abs().max()))
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
    del post_relu
    results.update(kernels_backward(act, weight, s_act, s_w_t, o_w_t, flush))
    results.update(kernels_floating(act, weight, s_w_t, flush))
    del act, weight
    return results


def _check_sums(name, got, terms, dims):
    """An LSQ sum of the kernel against the float64 sum of the plain
    version's per-element terms: rtol 1e-5 of the sum plus 1e-6 of the terms'
    absolute mass (which covers a sum that cancels). Returns the largest
    error as a share of that tolerance."""
    t = terms.double()
    exact = t.sum(dim=dims) if dims else t.sum()
    mass = t.abs().sum(dim=dims) if dims else t.abs().sum()
    err = (got.double() - exact).abs()
    tol = 1e-5 * exact.abs() + 1e-6 * mass
    if not bool(torch.all(err <= tol)):
        raise AssertionError(f'{name}: LSQ sum off by up to {float(err.max())}')
    return float((err / (tol + 1e-300)).max())


def kernels_backward(act, weight, s_act, s_w_t, o_w_t, flush):
    """Rows 4 and 5: the LSQ backward at the largest activation (tensorwise)
    and at a 512x512x3x3 weight on axis 0 (channelwise)."""
    from ppq_tpu_torch.core import RoundingPolicy
    from ppq_tpu_torch.kernels import linear_quant_bwd, linear_quant_bwd_plain
    from ppq_tpu_torch.kernels.quant import linear_quant_bwd_terms
    dev = act.device
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    cases = (
        ('fake_quant_bwd_tensorwise', act, None,
         torch.tensor(s_act, device=dev), torch.tensor(3.4, device=dev)),
        ('fake_quant_bwd_channelwise', weight, 0, s_w_t, o_w_t))
    for name, x, axis, s, o in cases:
        g = torch.randn(x.shape, device=dev, generator=gen) / x.numel()
        dims = None if axis is None else [i for i in range(x.ndim) if i != axis]
        err = rel = 0.0
        for policy in RoundingPolicy:
            for qmin, qmax in ((-128, 127), (0, 255)):
                dx, ds, do = linear_quant_bwd(x, g, s, o, qmin, qmax, policy, axis)
                again = linear_quant_bwd(x, g, s, o, qmin, qmax, policy, axis)
                want_dx, ds_e, do_e = linear_quant_bwd_terms(
                    x, g, s, o, qmin, qmax, policy, axis)
                if not torch.equal(dx.view(torch.int32), want_dx.view(torch.int32)):
                    raise AssertionError(f'{name}: dx != plain ({policy.name})')
                for a, b in zip((dx, ds, do), again):
                    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                        raise AssertionError(f'{name}: two runs differ')
                rel = max(rel, _check_sums(name, ds, ds_e, dims),
                          _check_sums(name, do, do_e, dims))
                err = max(err, float((dx - want_dx).abs().max()))
                del dx, ds, do, again, want_dx, ds_e, do_e
        ms = time_ms(lambda: linear_quant_bwd(x, g, s, o, -128, 127,
                                              RoundingPolicy.ROUND_HALF_EVEN, axis),
                     flush)
        if axis is not None:
            _timing_probe(name, lambda: linear_quant_bwd(
                x, g, s, o, -128, 127, RoundingPolicy.ROUND_HALF_EVEN, axis),
                flush)
        plain = time_ms(lambda: linear_quant_bwd_plain(
            x, g, s, o, -128, 127, RoundingPolicy.ROUND_HALF_EVEN, axis), flush)
        # yardstick: PyTorch's learnable fake-quant, forward and backward
        xs = x.clone().requires_grad_(True)
        ls = s.reshape(-1).clone().requires_grad_(True)
        lz = torch.zeros_like(ls).requires_grad_(True)

        def library():
            if axis is None:
                y = torch._fake_quantize_learnable_per_tensor_affine(
                    xs, ls, lz, -128, 127, 1.0)
            else:
                y = torch._fake_quantize_learnable_per_channel_affine(
                    xs, ls, lz, axis, -128, 127, 1.0)
            torch.autograd.grad(y, (xs, ls, lz), g)

        lib = time_ms(library, flush)
        n = x.numel()
        b, by = bound_ms(12.0 * n + 16.0 * s.numel(), 14.0 * n)
        results[name] = dict(max_abs_err=err, sums_share_of_tolerance=rel, ms=ms,
                             plain_ms=plain, library_ms=lib, bound_ms=b,
                             bound_by=by, shape=list(x.shape))
        log(f'[kernel] {name}: dx bit-equal under 7 policies x 2 ranges, '
            f'ds/do within rtol 1e-5 + 1e-6 of the mass of the float64 sum '
            f'(largest error {rel:.3f} of that tolerance), two runs bit-equal')
        del xs, g
    return results


def kernels_floating(act, weight, s_w_t, flush):
    """Rows 6 and 7: the floating fake-quant forward (tensorwise at the
    largest activation, channelwise at a weight) and its STE backward."""
    from ppq_tpu_torch.kernels import (floating_quant, floating_quant_bwd,
                                       floating_quant_bwd_plain,
                                       floating_quant_plain)
    dev = act.device
    gen = torch.Generator(device=dev).manual_seed(2)
    # values over many binades: normals, subnormals of the layouts, clips
    wide = act * torch.exp(torch.randn(act.shape, device=dev, generator=gen) * 3)
    g = torch.randn(act.shape, device=dev, generator=gen)
    s_dev = torch.tensor(0.37, device=dev)
    layouts = ((4, 3, 448.0), (5, 2, 57344.0), (3, 4, 15.5))
    err_fwd = err_bwd = 0.0

    def differ(what, got, want):
        """Bit equality, and the largest difference for the record."""
        if not torch.isfinite(want).all():
            raise AssertionError(f'{what}: the plain version is not finite')
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f'{what} != plain')
        return float((got - want).abs().max())

    for e, m, qmax in layouts:
        for x in (act, wide):
            for scale in (1.0, 0.37, s_dev):
                got = floating_quant(x, scale, e, m, -qmax, qmax)
                want = floating_quant_plain(x, scale, e, m, -qmax, qmax)
                err_fwd = max(err_fwd, differ(f'floating_quant E{e}M{m}',
                                              got, want))
                del got, want
        got = floating_quant(weight, s_w_t * 400, e, m, -qmax, qmax, 0)
        want = floating_quant_plain(weight, s_w_t * 400, e, m, -qmax, qmax, 0)
        err_fwd = max(err_fwd, differ(f'floating_quant channelwise E{e}M{m}',
                                      got, want))
        for scale in (0.37, s_dev):
            got = floating_quant_bwd(wide, g, scale, -qmax, qmax)
            want = floating_quant_bwd_plain(wide, g, scale, -qmax, qmax)
            err_bwd = max(err_bwd, differ('floating_quant_bwd', got, want))
        del got, want
    n = act.numel()
    results = {}
    b, by = bound_ms(8.0 * n, 12.0 * n)
    results['floating_quant'] = dict(
        max_abs_err=err_fwd, bound_ms=b, bound_by=by, shape=list(act.shape),
        ms=time_ms(lambda: floating_quant(act, 1.0, 4, 3, -448.0, 448.0), flush),
        plain_ms=time_ms(lambda: floating_quant_plain(act, 1.0, 4, 3, -448.0,
                                                      448.0), flush),
        library_ms=None,     # no single PyTorch call rounds to an E/M grid
        channelwise_ms=time_ms(lambda: floating_quant(
            weight, s_w_t, 4, 3, -448.0, 448.0, 0), flush),
        channelwise_plain_ms=time_ms(lambda: floating_quant_plain(
            weight, s_w_t, 4, 3, -448.0, 448.0, 0), flush),
        # the channelwise shape's own bound: the weight read and written
        # once, one scale a channel
        channelwise_bound_ms=bound_ms(8.0 * weight.numel() + 4.0 * s_w_t.numel(),
                                      12.0 * weight.numel())[0])
    b, by = bound_ms(12.0 * n, 3.0 * n)
    results['floating_quant_bwd'] = dict(
        max_abs_err=err_bwd, bound_ms=b, bound_by=by, shape=list(act.shape),
        ms=time_ms(lambda: floating_quant_bwd(act, g, 1.0, -448.0, 448.0), flush),
        plain_ms=time_ms(lambda: floating_quant_bwd_plain(act, g, 1.0, -448.0,
                                                          448.0), flush),
        library_ms=None)     # no single PyTorch call: a mask and a where
    log('[kernel] floating_quant: bit-equal to plain for E4M3, E5M2, E3M4, '
        'tensorwise (host and device scale) and channelwise; channelwise '
        f'weight {results["floating_quant"]["channelwise_ms"]:.4f} ms (plain '
        f'{results["floating_quant"]["channelwise_plain_ms"]:.4f} ms, bound '
        f'{results["floating_quant"]["channelwise_bound_ms"]:.4f} ms); '
        'floating_quant_bwd bit-equal')
    return results


def _bf16_step(want):
    return 2.0 ** -7 * want.abs()


def _qmm_tolerance(x, w, scale, row=None, res=None):
    """Rows 8 and 10 against their plain f32 result: both multiply the same
    bf16 operands exactly in f32 and differ in the order of the f32 sum: 1e-5
    of the row's absolute mass, plus one bf16 step where the output is bf16
    (a sum next to a rounding boundary may fall either way). Returns the f32
    result's (B, F) tolerance without the bf16 step, and the mass."""
    mass = torch.matmul(x.float().abs(), w.float().abs()) * scale
    if row is not None:
        mass = mass * row.reshape(-1, 1)
    if res is not None:
        mass = mass + res.float().abs()
    return 1e-5 * mass + 1e-6, mass


def _gateup_tolerance(x, w, scale, row):
    """silu's slope is at most 1.1, so the sums' tolerance carries over to
    silu(g) * u as 1.1e-5 * (mass_g |u| + mass_u |g|)."""
    Fh = w.shape[1] // 2
    both = torch.matmul(x.float(), w.float()) * scale
    _, mass = _qmm_tolerance(x, w, scale, row)
    if row is not None:
        both = both * row.reshape(-1, 1)
    return 1.1e-5 * (mass[:, :Fh] * both[:, Fh:].abs()
                     + mass[:, Fh:] * both[:, :Fh].abs()) + 1e-6


def _code_diff(got, want):
    """Largest difference between two lists of int8 code tensors."""
    return max(float((a.to(torch.int16) - b.to(torch.int16)).abs().max())
               for a, b in zip(got, want))


def _int8pack_mm_on_card() -> bool:
    """Whether this PyTorch build has a CUDA kernel for the one call that
    computes x @ w.T * scale from an int8 weight (a yardstick only)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        'aten::_weight_int8pack_mm', 'CUDA')


def _qmm_yardsticks(x, w, scale, flush):
    """Two single-call yardsticks on the same inputs, timed here and used
    nowhere in the port: a bf16 `matmul` on a weight already in bf16 (one
    cuBLAS call reading twice the weight's bytes) and, where this build has
    one on the card, `_weight_int8pack_mm` (the int8 weight transposed
    first, its scales in bf16; no row scale, residual or silu). Either is
    None where it does not exist or refuses the shape."""
    w16 = w.to(torch.bfloat16)
    mm = time_ms(lambda: torch.matmul(x, w16), flush)
    del w16
    pack, why = None, 'none on this build'
    if _int8pack_mm_on_card():
        wt, s16 = w.t().contiguous(), scale.to(torch.bfloat16)
        try:
            pack, why = time_ms(lambda: torch._weight_int8pack_mm(x, wt, s16),
                                flush), ''
        except RuntimeError as e:     # a yardstick, not a check of the port
            why = f'refused: {str(e).splitlines()[0][:120]}'
        del wt, s16
    return mm, pack, why


def _qmm_launch(B, d, f, gateup, int4=False):
    """S, the column tile and the load pipeline of a launch (d unpacked), as
    the wrapper of this checkout picks them."""
    from ppq_tpu_torch.kernels import qmm
    if hasattr(qmm, 'qmm_launch'):
        return json.dumps(qmm.qmm_launch(B, d, f, gateup, int4))
    if hasattr(qmm, 'int8_launch') and not int4:
        return json.dumps(qmm.int8_launch(B, d, f, gateup))
    return 'one block a tile (no split-K in this checkout)'


def _int4_splits_in(loader) -> bool:
    """Whether this checkout's INT4 entry points take split counts."""
    return len(loader.LIBRARIES['qmm'][1]['ppq_qmm_int4']) == 15


def _twice(fn, label):
    """Two calls, bit-equal, or raise; returns the first."""
    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f'{label}: two calls on the same inputs '
                             f'differ ({int(a.ne(b).sum())} outputs)')
    return a


def kernels_qmm(dev, flush):
    """Rows 8 and 10 (INT8 bodies) at path D's shapes (128 slots): every
    (D, F) and epilogue variant of the dequant-matmul that a decode step
    launches, and the gate-up kernel; each within its tolerance of the plain
    version in f32 and bf16, two calls on the same inputs bit-equal (also
    after calls of other shapes), timed beside the several-call composition
    and two single-call yardsticks."""
    from ppq_tpu_torch.kernels import (qmm_gateup, qmm_gateup_plain, qmm_int8,
                                       qmm_int8_plain)
    B, D, Fq, Fh, V = 128, SERVE['d_model'], 4096, SERVE['d_ff'], 32768
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16 = torch.bfloat16
    results = {}

    def weight(d, f):
        return (torch.randint(-127, 128, (d, f), device=dev, generator=gen,
                              dtype=torch.int8),
                torch.rand(f, device=dev, generator=gen) * 0.01 + 0.001)

    variants = {}
    worst = 0.0
    first = None
    cases = (('wqkv no epilogue', D, Fq, False, False),
             ('wqkv row_scale', D, Fq, True, False),
             ('wo residual', D, D, False, True),
             ('w_down residual', Fh, D, False, True),
             ('lm_head row_scale', D, V, True, False),
             ('wo row_scale+residual', D, D, True, True))
    for label, d, f, has_row, has_res in cases:
        x = torch.randn(B, d, device=dev, generator=gen).to(bf16)
        w, scale = weight(d, f)
        row = torch.rand(B, device=dev, generator=gen) + 0.5 if has_row else None
        res = torch.randn(B, f, device=dev, generator=gen).to(bf16) if has_res else None
        want = qmm_int8_plain(x, w, scale, torch.float32, row, res)
        tol, _ = _qmm_tolerance(x, w, scale, row)
        for out in (torch.float32, bf16):
            got = _twice(lambda: qmm_int8(x, w, scale, out, row, res),
                         f'qmm_int8 {label} {out}')
            err = (got.float() - want).abs()
            lim = tol + (_bf16_step(want) if out == bf16 else 0.0)
            if not bool((err <= lim).all()):
                raise AssertionError(f'qmm_int8 {label} {out}: off by up to '
                                     f'{float((err / lim).max()):.2f} of the tolerance')
            if out == torch.float32 and float(err.max()) >= worst:
                worst, worst_of = float(err.max()), float(want.flatten()[err.argmax()])
            if first is None:
                first = (x, w, scale, got)
        ms = time_ms(lambda: qmm_int8(x, w, scale, bf16, row, res), flush)
        plain = time_ms(lambda: qmm_int8_plain(x, w, scale, bf16, row, res), flush)

        def library():
            out = torch.matmul(x, w.to(bf16)).float() * scale
            if row is not None:
                out = out * row.reshape(-1, 1)
            if res is not None:
                out = out + res
            return out.to(bf16)

        composed = time_ms(library, flush)
        mm, pack, why = _qmm_yardsticks(x, w, scale, flush)
        moved = d * f + 2 * B * d + 4 * f + 2 * B * f \
            + (4 * B if has_row else 0) + (2 * B * f if has_res else 0)
        b, by = bound_ms(moved, 2.0 * B * d * f, BF16_OPS_PER_S)
        variants[label] = dict(shape=[B, d, f], ms=ms, plain_ms=plain,
                               composed_ms=composed, bf16_matmul_ms=mm,
                               int8pack_mm_ms=pack, bound_ms=b, bound_by=by,
                               launch=_qmm_launch(B, d, f, False))
        pack_s = f'{pack:.4f} ms' if pack is not None else why
        log(f'[kernel] qmm_int8 {label} {[B, d, f]}: {ms:.4f} ms '
            f'({variants[label]["launch"]}), plain {plain:.4f} ms, library '
            f'(to bf16 + matmul + epilogue, several calls) {composed:.4f} ms, '
            f'bf16 matmul on a bf16 weight {mm:.4f} ms, _weight_int8pack_mm '
            f'{pack_s}, bound {b:.4f} ms ({by}), share of bound {b / ms:.3f}')
        del x, w, scale, row, res, want, tol
    # the first shape again, after calls of every other shape
    x, w, scale, got = first
    if not torch.equal(qmm_int8(x, w, scale, torch.float32), got):
        raise AssertionError('qmm_int8: a call after calls of other shapes '
                             'differs from the first call on its inputs')
    del first, x, w, scale, got
    wq = variants['wqkv no epilogue']
    # one PyTorch call computes this variant (scales in bf16), where the
    # build has it; else the several-call composition as before
    results['qmm_int8'] = dict(
        max_abs_err=worst, variants=variants,
        library_ms=(wq['int8pack_mm_ms'] if wq['int8pack_mm_ms'] is not None
                    else wq['composed_ms']),
        **{k: v for k, v in wq.items() if k not in ('composed_ms',)})
    log(f'[kernel] qmm_int8 largest f32 error {worst:.3e} on an output of '
        f'{worst_of:.3e}; every variant bit-equal over two calls and after '
        f'calls of other shapes')

    x = torch.randn(B, D, device=dev, generator=gen).to(bf16)
    w, scale = weight(D, 2 * Fh)
    row = torch.rand(B, device=dev, generator=gen) + 0.5
    worst = 0.0
    for r in (row, None):
        want = qmm_gateup_plain(x, w, scale, torch.float32, r)
        tol = _gateup_tolerance(x, w, scale, r)
        for out in (torch.float32, bf16):
            got = _twice(lambda: qmm_gateup(x, w, scale, out, r),
                         f'qmm_gateup {out}')
            err = (got.float() - want).abs()
            lim = tol + (_bf16_step(want) if out == bf16 else 0.0)
            if not bool((err <= lim).all()):
                raise AssertionError(f'qmm_gateup {out}: off by up to '
                                     f'{float((err / lim).max()):.2f} of the tolerance')
            if out == torch.float32 and float(err.max()) >= worst:
                worst, worst_of = float(err.max()), float(want.flatten()[err.argmax()])
        del want, tol
    log(f'[kernel] qmm_gateup largest f32 error {worst:.3e} on an output of '
        f'{worst_of:.3e}; bit-equal over two calls')

    def library_gateup():
        both = torch.matmul(x, w.to(bf16)).float() * scale * row.reshape(-1, 1)
        return (torch.nn.functional.silu(both[:, :Fh]) * both[:, Fh:]).to(bf16)

    moved = D * 2 * Fh + 2 * B * D + 8 * Fh + 4 * B + 2 * B * Fh
    b, by = bound_ms(moved, 2.0 * B * D * 2 * Fh, BF16_OPS_PER_S)
    mm, pack, why = _qmm_yardsticks(x, w, scale, flush)
    results['qmm_gateup'] = dict(
        max_abs_err=worst, shape=[B, D, 2 * Fh], bound_ms=b, bound_by=by,
        ms=time_ms(lambda: qmm_gateup(x, w, scale, bf16, row), flush),
        plain_ms=time_ms(lambda: qmm_gateup_plain(x, w, scale, bf16, row), flush),
        # yardstick, several calls: to bf16, matmul, scales, silu, mul
        library_ms=time_ms(library_gateup, flush),
        bf16_matmul_ms=mm, int8pack_mm_ms=pack,
        launch=_qmm_launch(B, D, Fh, True))
    r = results['qmm_gateup']
    pack_s = f'{pack:.4f} ms' if pack is not None else why
    log(f'[kernel] qmm_gateup {[B, D, 2 * Fh]}: {r["ms"]:.4f} ms '
        f'({r["launch"]}), plain {r["plain_ms"]:.4f} ms, library (several '
        f'calls) {r["library_ms"]:.4f} ms, bf16 matmul of the projection on '
        f'a bf16 weight {mm:.4f} ms, _weight_int8pack_mm of the projection '
        f'{pack_s}, bound {b:.4f} ms ({by}), share of bound {b / r["ms"]:.3f}')
    del x, w, scale, row
    torch.cuda.empty_cache()
    return results


def qmm_sweep(dev, flush):
    """`--qmm` only: each body at the decode shapes of paths D (INT8) and F
    (INT4), with the epilogue a decode step gives it, at every split count
    the kernel takes up to 16, through its C entry point with the wrapper's
    workspace (the port picks S from the shape; this measures that choice
    against the others and fits _splits' cost model). The INT4 bodies are
    swept where this checkout's take split counts."""
    from ppq_tpu_torch.kernels import loader, qmm
    lib = loader.library('qmm')
    gen = torch.Generator(device=dev).manual_seed(5)
    B, stream = 128, loader.stream_of(dev)
    shapes = [('wqkv row_scale', 2048, 4096, False, False),
              ('wo residual', 2048, 2048, False, True),
              ('w_down residual', 5632, 2048, False, True),
              ('lm_head row_scale', 2048, 32768, False, False),
              ('gate-up row_scale', 2048, SERVE['d_ff'], True, False)]
    cases = [(label, D, F, gateup, has_res, False)
             for label, D, F, gateup, has_res in shapes]
    if _int4_splits_in(loader):
        cases += [(f'INT4 {label}', D, F, gateup, has_res, True)
                  for label, D, F, gateup, has_res in shapes
                  if not label.startswith('lm_head')]
    for label, D, F, gateup, has_res, int4 in cases:
        Fw = 2 * F if gateup else F
        x = torch.randn(B, D, device=dev, generator=gen).to(torch.bfloat16)
        w = torch.randint(-127, 128, (D // 2 if int4 else D, Fw),
                          device=dev, generator=gen, dtype=torch.int8)
        scale = torch.rand(Fw, device=dev, generator=gen) * 0.01 + 0.001
        row = None if has_res else torch.rand(B, device=dev, generator=gen) + 0.5
        res = torch.randn(B, F, device=dev, generator=gen).to(torch.bfloat16) \
            if has_res else None
        out = torch.empty(B, F, dtype=torch.bfloat16, device=dev)
        steps = D // 64
        counts = sorted({-(-steps // -(-steps // s))
                         for s in range(1, min(16, steps // 4) + 1)})
        times = {}
        for S in counts:
            ws, counters = qmm._workspace(
                dev, torch.cuda.current_stream(dev).cuda_stream, S * B * Fw,
                F // (64 if gateup else 128))

            def run():
                rp = None if row is None else row.data_ptr()
                if gateup:
                    entry = lib.ppq_qmm_gateup_int4 if int4 \
                        else lib.ppq_qmm_gateup
                    return entry(
                        x.data_ptr(), w.data_ptr(), scale.data_ptr(), rp,
                        out.data_ptr(), 0, B, D, F, S, ws.data_ptr(),
                        counters.data_ptr(), stream)
                entry = lib.ppq_qmm_int4 if int4 else lib.ppq_qmm_int8
                return entry(
                    x.data_ptr(), w.data_ptr(), scale.data_ptr(), rp,
                    None if res is None else res.data_ptr(), 0,
                    out.data_ptr(), 0, B, D, F, S, ws.data_ptr(),
                    counters.data_ptr(), stream)
            if run() != 0:
                raise AssertionError(f'qmm sweep {label}: S {S} refused')
            times[S] = time_ms(run, flush)
        # the parent's _splits has no body argument and sweeps no INT4 body
        picked = qmm._splits(D, F, gateup, True) if int4 \
            else qmm._splits(D, F, gateup)
        log(f'[qmm sweep] {label} {[B, D, Fw]}: ' + ', '.join(
            f'S {S} {t:.4f} ms' for S, t in times.items()) +
            f'; _splits picks S {picked}')
        del x, w, scale, row, res, out


def kernels_bank(dev, flush):
    """Row 14 at path D's shape: one column of 2L buffers (B, CH, KV, Dh)
    int8, the column on the card, bit-equal to the indexed assignment at
    three columns, then timed."""
    from ppq_tpu_torch.kernels import Bank, bank_write_inplace, bank_write_plain
    B, L, KV, Dh = 128, SERVE['n_layers'], SERVE['n_kv_heads'], 128
    gen = torch.Generator(device=dev).manual_seed(14)

    def codes(shape):
        return torch.randint(-128, 128, shape, device=dev, generator=gen,
                             dtype=torch.int8)

    bufs = [codes((B, BURST, KV, Dh)) for _ in range(2 * L)]
    want = [t.clone() for t in bufs]
    news = [codes((B, 1, KV, Dh)) for _ in range(2 * L)]
    # the buffers checked once, as the burst has them
    bank, bank_want = Bank(bufs), Bank(want)
    worst = 0.0
    for col in (0, 17, BURST - 1):
        col_dev = torch.tensor([col], dtype=torch.int32, device=dev)
        bank_write_inplace(bank, news, col_dev)
        bank_write_plain(bank_want, news, col_dev)
        worst = max(worst, _code_diff(bufs, want))
        if not all(torch.equal(a, b) for a, b in zip(bufs, want)):
            raise AssertionError(f'bank_write != plain (column {col})')
    col_dev = torch.tensor([5], dtype=torch.int32, device=dev)

    def library_bank():
        for buf, new in zip(bufs, news):
            buf[:, 5].copy_(new[:, 0])

    moved = 2.0 * 2 * L * B * KV * Dh
    b, by = bound_ms(moved, 0.0)
    result = dict(
        max_abs_err=worst, shape=[2 * L, B, BURST, KV, Dh], bound_ms=b,
        bound_by=by,
        ms=time_ms(lambda: bank_write_inplace(bank, news, col_dev), flush),
        plain_ms=time_ms(lambda: bank_write_plain(bank_want, news, col_dev),
                         flush),
        # yardstick, 2L calls with the column known on the host
        library_ms=time_ms(library_bank, flush))
    _timing_probe('bank_write', lambda: bank_write_inplace(bank, news, col_dev),
                  flush)
    return {'bank_write': result}


def kernels_serving(dev, flush):
    """Rows 8, 10, 14, 15 at path D's shapes (128 slots): the dequant-matmul
    variants and the gate-up kernel (kernels_qmm), the one-column bank write
    over 32 buffers (kernels_bank) and the 32-row window write into the full
    KV cache."""
    from ppq_tpu_torch.kernels import window_write_inplace, window_write_plain
    B = 128
    L, KV, Dh, S = SERVE['n_layers'], SERVE['n_kv_heads'], 128, SERVE['max_seq_len']
    gen = torch.Generator(device=dev).manual_seed(4)
    results = kernels_qmm(dev, flush)

    def codes(shape):
        return torch.randint(-128, 128, shape, device=dev, generator=gen,
                             dtype=torch.int8)

    results.update(kernels_bank(dev, flush))

    # row 15: a 32-row window per slot into the k and v slabs of the cache
    slabs = [torch.zeros((L, B, S, KV, Dh), dtype=torch.int8, device=dev)
             for _ in range(2)]
    want = [t.clone() for t in slabs]
    news = [codes((L, B, BURST, KV, Dh)) for _ in range(2)]
    pos = torch.randint(0, S - BURST + 1, (B,), device=dev, generator=gen,
                        dtype=torch.int32)
    pos[0], pos[1] = 0, S - BURST
    window_write_inplace(slabs, news, pos)
    window_write_plain(want, news, pos)
    worst = _code_diff(slabs, want)
    if not all(torch.equal(a, b) for a, b in zip(slabs, want)):
        raise AssertionError('window_write != plain')
    if int(slabs[0].ne(0).sum()) != int(news[0].ne(0).sum()):
        raise AssertionError('window_write wrote outside its windows')
    host_pos = pos.tolist()

    def library_window():
        for slab, new in zip(slabs, news):
            for slot, p in enumerate(host_pos):
                slab[:, slot, p:p + BURST].copy_(new[:, slot])

    moved = 2.0 * 2 * L * B * BURST * KV * Dh + 4 * B
    b, by = bound_ms(moved, 0.0)
    results['window_write'] = dict(
        max_abs_err=worst, shape=[2, L, B, S, KV, Dh], window=BURST, bound_ms=b,
        bound_by=by,
        ms=time_ms(lambda: window_write_inplace(slabs, news, pos), flush),
        plain_ms=time_ms(lambda: window_write_plain(want, news, pos), flush),
        # yardstick, 2B calls with the rows known on the host
        library_ms=time_ms(library_window, flush))
    log('[kernel] qmm_int8 and qmm_gateup within 1e-5 of the row\'s absolute '
        'mass of the plain f32 result (plus one bf16 step for a bf16 output); '
        'bank_write and window_write bit-equal to the indexed assignment')
    del slabs, want, news
    torch.cuda.empty_cache()
    return results


def kernels_int4(dev, flush):
    """Row 9 and row 10's INT4 body at path F's shapes (128 slots) and row
    9 at a tp-2 rank's w_down shard (path O), each with the epilogue a
    decode step gives it: the weights split-half packed, held
    against their plain versions (the nibbles unpacked, then row 8's and
    row 10's arithmetic) with rows 8 and 10's tolerances on the unpacked
    weight in f32 and bf16, two calls on the same inputs bit-equal (also
    after calls of other shapes), timed beside the several-call
    composition."""
    from ppq_tpu_torch.kernels import (pack_int4_splithalf, qmm_gateup,
                                       qmm_gateup_plain, qmm_int4,
                                       qmm_int4_plain, unpack_int4_splithalf)
    B, D, Fq, Fh = 128, SERVE['d_model'], 4096, SERVE['d_ff']
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16 = torch.bfloat16
    results = {}

    def weight(d, f):
        codes = torch.randint(-8, 8, (d, f), device=dev, generator=gen,
                              dtype=torch.int8)
        return (codes, pack_int4_splithalf(codes),
                torch.rand(f, device=dev, generator=gen) * 0.01 + 0.001)

    variants = {}
    worst = 0.0
    first = None
    for label, d, f, has_row, has_res in (
            ('wqkv row_scale', D, Fq, True, False),
            ('wo residual', D, D, False, True),
            ('w_down residual', Fh, D, False, True),
            # a tp-2 rank's w_down shard (path O): 1408 packed rows
            ('w_down tp-2 shard residual', Fh // 2, D, False, True)):
        x = torch.randn(B, d, device=dev, generator=gen).to(bf16)
        codes, w, scale = weight(d, f)
        row = torch.rand(B, device=dev, generator=gen) + 0.5 if has_row else None
        res = torch.randn(B, f, device=dev, generator=gen).to(bf16) if has_res else None
        want = qmm_int4_plain(x, w, scale, torch.float32, row, res)
        tol, _ = _qmm_tolerance(x, codes, scale, row)
        for out in (torch.float32, bf16):
            got = _twice(lambda: qmm_int4(x, w, scale, out, row, res),
                         f'qmm_int4 {label} {out}')
            err = (got.float() - want).abs()
            lim = tol + (_bf16_step(want) if out == bf16 else 0.0)
            if not bool((err <= lim).all()):
                raise AssertionError(f'qmm_int4 {label} {out}: off by up to '
                                     f'{float((err / lim).max()):.2f} of the tolerance')
            if out == torch.float32 and float(err.max()) >= worst:
                worst, worst_of = float(err.max()), float(want.flatten()[err.argmax()])
            if first is None:
                first = (x, w, scale, row, res, got)

        def library():
            out = torch.matmul(x, unpack_int4_splithalf(w).to(bf16)).float() * scale
            if row is not None:
                out = out * row.reshape(-1, 1)
            if res is not None:
                out = out + res
            return out.to(bf16)

        moved = d // 2 * f + 2 * B * d + 4 * f + 2 * B * f \
            + (4 * B if has_row else 0) + (2 * B * f if has_res else 0)
        b, by = bound_ms(moved, 2.0 * B * d * f, BF16_OPS_PER_S)
        variants[label] = dict(
            shape=[B, d, f], bound_ms=b, bound_by=by,
            ms=time_ms(lambda: qmm_int4(x, w, scale, bf16, row, res), flush),
            plain_ms=time_ms(lambda: qmm_int4_plain(x, w, scale, bf16, row, res),
                             flush),
            # yardstick, several calls: unpack, to bf16, matmul, epilogue
            library_ms=time_ms(library, flush),
            launch=_qmm_launch(B, d, f, False, int4=True))
        v = variants[label]
        log(f'[kernel] qmm_int4 {label} {[B, d, f]}: {v["ms"]:.4f} ms '
            f'({v["launch"]}), plain {v["plain_ms"]:.4f} ms, library (unpack '
            f'+ to bf16 + matmul + epilogue, several calls) '
            f'{v["library_ms"]:.4f} ms, bound {b:.4f} ms ({by}), share of '
            f'bound {b / v["ms"]:.3f}')
        del x, codes, w, scale, row, res, want, tol
    results['qmm_int4'] = dict(max_abs_err=worst, variants=variants,
                               **variants['wqkv row_scale'])
    log(f'[kernel] qmm_int4 largest f32 error {worst:.3e} on an output of '
        f'{worst_of:.3e}; every variant bit-equal over two calls')

    x = torch.randn(B, D, device=dev, generator=gen).to(bf16)
    codes, w, scale = weight(D, 2 * Fh)
    row = torch.rand(B, device=dev, generator=gen) + 0.5
    worst = 0.0
    for r in (row, None):
        want = qmm_gateup_plain(x, w, scale, torch.float32, r)
        tol = _gateup_tolerance(x, codes, scale, r)
        for out in (torch.float32, bf16):
            got = _twice(lambda: qmm_gateup(x, w, scale, out, r),
                         f'qmm_gateup INT4 {out}')
            err = (got.float() - want).abs()
            lim = tol + (_bf16_step(want) if out == bf16 else 0.0)
            if not bool((err <= lim).all()):
                raise AssertionError(f'qmm_gateup INT4 {out}: off by up to '
                                     f'{float((err / lim).max()):.2f} of the tolerance')
            if out == torch.float32 and float(err.max()) >= worst:
                worst, worst_of = float(err.max()), float(want.flatten()[err.argmax()])
        del want, tol
    # the first shape again, after calls of every other shape
    x1, w1, s1, r1, res1, got1 = first
    if not torch.equal(qmm_int4(x1, w1, s1, torch.float32, r1, res1), got1):
        raise AssertionError('qmm_int4: a call after calls of other shapes '
                             'differs from the first call on its inputs')
    del first, x1, w1, s1, r1, res1, got1
    log(f'[kernel] qmm_gateup_int4 largest f32 error {worst:.3e} on an output '
        f'of {worst_of:.3e}; bit-equal over two calls and after calls of '
        f'other shapes')

    def library_gateup():
        both = torch.matmul(x, unpack_int4_splithalf(w).to(bf16)).float() \
            * scale * row.reshape(-1, 1)
        return (torch.nn.functional.silu(both[:, :Fh]) * both[:, Fh:]).to(bf16)

    moved = D // 2 * 2 * Fh + 2 * B * D + 8 * Fh + 4 * B + 2 * B * Fh
    b, by = bound_ms(moved, 2.0 * B * D * 2 * Fh, BF16_OPS_PER_S)
    results['qmm_gateup_int4'] = dict(
        max_abs_err=worst, shape=[B, D, 2 * Fh], bound_ms=b, bound_by=by,
        ms=time_ms(lambda: qmm_gateup(x, w, scale, bf16, row), flush),
        plain_ms=time_ms(lambda: qmm_gateup_plain(x, w, scale, bf16, row), flush),
        # yardstick, several calls: unpack, to bf16, matmul, scales, silu, mul
        library_ms=time_ms(library_gateup, flush),
        launch=_qmm_launch(B, D, Fh, True, int4=True))
    r = results['qmm_gateup_int4']
    log(f'[kernel] qmm_gateup_int4 {[B, D, 2 * Fh]}: {r["ms"]:.4f} ms '
        f'({r["launch"]}), plain {r["plain_ms"]:.4f} ms, library (several '
        f'calls) {r["library_ms"]:.4f} ms, bound {b:.4f} ms ({by}), share of '
        f'bound {b / r["ms"]:.3f}')
    del x, codes, w, scale, row
    torch.cuda.empty_cache()
    return results


def _attention_tolerance(got, want, q, k, v, ks, vs, lens):
    """Rows 11 and 12 against their plain versions on the same inputs.
    s sums Dh exact bf16 x code products in another order: delta = 2e-5 of
    its absolute mass sum |q||k| k_scale / sqrt(Dh) (m's tolerance); p moves
    by 2 delta relative; l sums n values of p in another order (l (4 delta
    + 2 n 2^-24)); acc sums p v_scale rounded to bf16 times v, where a p
    that moved may round to the neighbouring bf16 number: sum |p vs v| (2^-7
    + 4 delta + 2 n 2^-24). k, v: the slots' (B, S, KV, Dh); ks, vs
    (B, S, KV) or None. Raises past the tolerance; returns the worst share
    of it, and the largest |acc| difference."""
    B, KV, rep, Dh = q.shape
    S = k.shape[1]
    qf = q.float()
    kss = torch.ones(k.shape[:3], device=q.device) if ks is None else ks
    vss = torch.ones(k.shape[:3], device=q.device) if vs is None else vs
    lens = lens.long().clamp(0, S)
    valid = (torch.arange(S, device=q.device)[None] < lens[:, None])[:, None, None, :]
    inv = 1.0 / np.sqrt(Dh)
    kt = kss.transpose(1, 2)[:, :, None]
    s = torch.einsum('bkrd,bskd->bkrs', qf, k.float()) * kt * inv
    mass = torch.einsum('bkrd,bskd->bkrs', qf.abs(), k.float().abs()) * kt * inv
    s = torch.where(valid, s, -torch.inf)
    m_ref = s.amax(-1).clamp_min(-1e30)
    p = torch.where(valid, torch.exp(s - m_ref[..., None]), 0.0)
    del s
    n = lens.float()[:, None, None]
    delta = 2e-5 * torch.where(valid, mass, 0.0).amax(-1) + 1e-6
    del mass
    summ = 2 * n * 2.0 ** -24
    acc_mass = torch.einsum('bkrs,bskd->bkrd', p * vss.transpose(1, 2)[:, :, None],
                            v.float().abs())
    (ga, gm, gl), (wa, wm, wl) = got, want
    shares = [float(((gm - wm).abs() / delta).max()),
              float(((gl - wl).abs() / (wl * (4 * delta + summ) + 1e-30)).max()),
              float(((ga - wa).abs() / (acc_mass * (2.0 ** -7 + 4 * delta[..., None]
                                                    + summ[..., None]) + 1e-6)).max())]
    empty = lens == 0
    if max(shares) > 1.0 or not bool((ga[empty] == 0).all()) \
            or not bool((gl[empty] == 0).all()):
        raise AssertionError(f'paged attention off its plain version: shares '
                             f'of the tolerance (m, l, acc) {shares}')
    return max(shares), float((ga - wa).abs().max())


def _dense_slots(pool, scale, layer, B, tables=None):
    """The slots' dense (B, S, KV, Dh) k and v and (B, S, KV) scales behind a
    fused pool read through `tables`, or a block-major window (tables
    None)."""
    pool = pool[layer]
    scale = None if scale is None else scale[layer]
    NB, _, BLK, KVDh = pool.shape
    if tables is None:
        MB = NB // B
        blocks = pool.view(MB, B, 2, BLK, KVDh).transpose(0, 1)
        sc = None if scale is None else \
            scale[..., :BLK].reshape(MB, B, 2, -1, BLK).transpose(0, 1)
    else:
        MB = tables.shape[1]
        blocks = pool[tables.long()]
        sc = None if scale is None else scale[tables.long()]
    KV = KVDh // 128
    k = blocks[:, :, 0].reshape(B, MB * BLK, KV, 128)
    v = blocks[:, :, 1].reshape(B, MB * BLK, KV, 128)
    if sc is None:
        return k, v, None, None
    ks = sc[:, :, 0].transpose(-1, -2).reshape(B, MB * BLK, KV)
    vs = sc[:, :, 1].transpose(-1, -2).reshape(B, MB * BLK, KV)
    return k, v, ks, vs


def _attention_bound(lens, q, pool, tables_cols=0):
    """Bytes: every filled position's K and V head rows and their scales,
    read once; q read, (acc, m, l) written once; the fills and tables.
    Operations: 4 rep Dh a position and KV head, at the bf16 rate."""
    B, KV, rep, Dh = q.shape
    tokens = float(lens.long().sum())
    moved = tokens * (2 * KV * Dh * pool.element_size() + 2 * KV * 4) \
        + B * KV * rep * Dh * 2 + B * KV * rep * (Dh + 2) * 4 + 4 * B \
        + 4 * B * tables_cols
    return bound_ms(moved, tokens * KV * rep * Dh * 4.0, BF16_OPS_PER_S)


def kernels_ragged(dev, flush):
    """Rows 11 and 12 at path E's launch shapes: 128 slots, 8 KV heads of
    128, the int8 cache of max_seq_len 1024 (16 layers of it here). Row 11 at fill 512 (window
    512, one 512-position block a slot, the layout `burst_forward` repacks
    for the per-slot kernel); row 12 at fill 16 (window 32, blocks of 32,
    groups of 32). Each against its plain version at the path's fills and
    at mixed fills; the library column is the dense read that path D does
    for one layer at the same fill (upcast, two products and softmax:
    several calls). Also the repack of the window, per burst."""
    from ppq_tpu_torch.kernels import (blockmajor_window, grouped_group_size,
                                       identity_block_tables,
                                       paged_attention_decode_fused,
                                       paged_attention_decode_fused_plain,
                                       paged_attention_decode_grouped,
                                       paged_attention_decode_grouped_plain,
                                       read_faults, slotmajor_window)
    from ppq_tpu_torch.serving.model import _pv_context, _qk_logits
    B, L, KV, S = SERVE['max_batch'], SERVE['n_layers'], SERVE['n_kv_heads'], SERVE['max_seq_len']
    rep, Dh = SERVE['n_heads'] // KV, SERVE['d_model'] // SERVE['n_heads']
    gen = torch.Generator(device=dev).manual_seed(5)
    cache = {key: torch.randint(-128, 128, (L, B, S, KV, Dh), device=dev,
                                generator=gen, dtype=torch.int8)
             for key in ('k', 'v')}
    for key in ('k_scale', 'v_scale'):
        cache[key] = torch.rand(L, B, S, KV, device=dev, generator=gen) * 0.02 + 0.001
    q = torch.randn(B, KV, rep, Dh, device=dev, generator=gen).bfloat16()
    layer = L // 2
    results = {}
    read_faults(dev)

    def dense_read(fill, bucket):
        """Path D's frozen-cache read for one layer (without its in-burst
        part): codes upcast, logits, softmax, the context product."""
        lens = torch.full((B,), fill, dtype=torch.int32, device=dev)
        q5 = q[:, None]
        mask = (torch.arange(bucket, device=dev)[None, None, None, :]
                < lens[:, None, None, None])

        def run():
            lf = _qk_logits(q5, cache['k'][layer][:, :bucket])[:, :, :, 0, :]
            lf = lf * cache['k_scale'][layer][:, :bucket].transpose(1, 2)[:, :, None, :]
            lf = torch.where(mask, lf / np.sqrt(Dh), -1e30)
            pf = torch.softmax(lf, dim=-1) \
                * cache['v_scale'][layer][:, :bucket].transpose(1, 2)[:, :, None, :]
            return _pv_context(pf[:, :, :, None, :], cache['v'][layer][:, :bucket])
        return time_ms(run, flush)

    # row 11: fill 512 takes the per-slot kernel, one block of 512
    cap, blk = 512, 512
    repack_fused = time_ms(lambda: slotmajor_window(
        cache['k'], cache['v'], cache['k_scale'], cache['v_scale'], cap, blk), flush)
    pool, sc = slotmajor_window(cache['k'], cache['v'], cache['k_scale'],
                                cache['v_scale'], cap, blk)
    tables = identity_block_tables(B, cap, blk, dev)
    path_lens = torch.full((B,), 512, dtype=torch.int32, device=dev)
    mixed = torch.randint(0, cap + 1, (B,), device=dev, generator=gen,
                          dtype=torch.int32)
    mixed[::9] = 0
    worst = 0.0
    dense = _dense_slots(pool, sc, layer, B, tables)
    for lens in (path_lens, mixed):
        share, err = _hold_triple(
            'paged_attention_fused',
            lambda l: paged_attention_decode_fused(q, pool, sc, tables, l,
                                                   layer, block_size=blk),
            lambda l: paged_attention_decode_fused_plain(
                q, pool, sc, tables, l, layer, block_size=blk),
            q, dense, lens)
        worst = max(worst, err)
        log(f'[kernel] paged_attention_fused: worst share of the tolerance '
            f'{share:.3f}, largest |acc| difference {err:.3e}; two calls '
            f'bit-equal')
    b, by = _attention_bound(path_lens, q, pool, tables.shape[1])
    results['paged_attention_fused'] = dict(
        max_abs_err=worst, shape=[B, KV, rep, Dh, L, B * cap // blk, blk],
        fill=512, bound_ms=b, bound_by=by, repack_ms_per_burst=repack_fused,
        ms=time_ms(lambda: paged_attention_decode_fused(
            q, pool, sc, tables, path_lens, layer, block_size=blk), flush),
        plain_ms=time_ms(lambda: paged_attention_decode_fused_plain(
            q, pool, sc, tables, path_lens, layer, block_size=blk), flush),
        # yardstick, several calls: path D's dense read of one layer
        library_ms=dense_read(512, 512))
    del pool, sc, dense

    # row 12: fill 16 takes the grouped kernel, window 32, blocks of 32
    cap = blk = 32
    G = grouped_group_size(B, blk, kv_dh=KV * Dh, itemsize=1)
    repack_grouped = time_ms(lambda: blockmajor_window(
        cache['k'], cache['v'], cache['k_scale'], cache['v_scale'], cap, blk), flush)
    kv_bm, sc_bm = blockmajor_window(cache['k'], cache['v'], cache['k_scale'],
                                     cache['v_scale'], cap, blk)
    path_lens = torch.full((B,), 16, dtype=torch.int32, device=dev)
    mixed = torch.randint(0, cap + 1, (B,), device=dev, generator=gen,
                          dtype=torch.int32)
    mixed[::5] = 0
    worst = 0.0
    dense = _dense_slots(kv_bm, sc_bm, layer, B)
    for lens in (path_lens, mixed):
        share, err = _hold_triple(
            'paged_attention_grouped',
            lambda l: paged_attention_decode_grouped(
                q, kv_bm, sc_bm, l, layer, block_size=blk, group=G),
            lambda l: paged_attention_decode_grouped_plain(
                q, kv_bm, sc_bm, l, layer, block_size=blk, group=G),
            q, dense, lens)
        worst = max(worst, err)
        log(f'[kernel] paged_attention_grouped: worst share of the tolerance '
            f'{share:.3f}, largest |acc| difference {err:.3e}; two calls '
            f'bit-equal')
    b, by = _attention_bound(path_lens, q, kv_bm)
    results['paged_attention_grouped'] = dict(
        max_abs_err=worst, shape=[B, KV, rep, Dh, L, B * cap // blk, blk],
        fill=16, group=G, bound_ms=b, bound_by=by,
        repack_ms_per_burst=repack_grouped,
        ms=time_ms(lambda: paged_attention_decode_grouped(
            q, kv_bm, sc_bm, path_lens, layer, block_size=blk, group=G), flush),
        plain_ms=time_ms(lambda: paged_attention_decode_grouped_plain(
            q, kv_bm, sc_bm, path_lens, layer, block_size=blk, group=G), flush),
        library_ms=dense_read(16, 32))
    faults = read_faults(dev)
    if faults:
        raise AssertionError(f'the kernels reported faults: {faults}')
    log(f'[kernel] window repack (16 layers, 128 slots) per burst: '
        f'{repack_fused:.4f} ms at window 512 (per-slot layout), '
        f'{repack_grouped:.4f} ms at window 32 (block-major)')
    log('[kernel] rows 9 and 10 INT4 within rows 8 and 10\'s tolerances on '
        'the unpacked weight; rows 11 and 12 within the attention tolerance '
        '(2e-5 of the logits\' mass; one bf16 step of p v_scale)')
    del cache, kv_bm, sc_bm, dense, q
    torch.cuda.empty_cache()
    return results


def _edge_fills(B, cap, dev):
    """Fills that end inside a pass, on one, inside and on a stage of 64
    positions and on the window, an empty slot among them, over B slots."""
    edges = [0, 1, 3, 15, 16, 17, 33, 63, 64, 65, 127, 128, 200, 255, 256,
             257, 511, 512]
    fills = [f for f in edges if f <= cap] + [cap]
    return torch.tensor([fills[i % len(fills)] for i in range(B)],
                        dtype=torch.int32, device=dev)


def _hold_triple(label, run, plain, q, dense, lens):
    """One of rows 11, 12 against its plain version, two calls bit-equal;
    returns the worst share of the tolerance and the largest |acc|
    difference."""
    got, again = run(lens), run(lens)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f'{label}: two calls on the same inputs differ')
    return _attention_tolerance(got, plain(lens), q, *dense, lens)


def kernels_attention(dev, flush):
    """`--attention` only: rows 11 and 12 at the four shapes the paths give
    them (128 slots, 8 KV heads of 128, rep 2, the int8 cache of 16 layers
    of max_seq_len 1024): row 11 at fill 512, one 512-position block a slot
    (paths E, F); row 12 at fill 16 over blocks of 32 in groups of 32
    (paths E, F, and G's benchmark at fill 16); row 12 over path G's blocks
    of 256 at fill 512 (two blocks a slot) and at fill 16 (one partial
    block: a shallow slot of `run` beside deep ones). Each against its plain
    version at the path's fill, at mixed fills with empty slots and at
    fills that end inside and on a pass and a stage, two calls bit-equal;
    timed (its own flush before each call) beside its bound. Also the
    launch floor (an empty kernel, timed the same way) and what an SM holds
    of the kernel, where this checkout has the entry points."""
    from ppq_tpu_torch.kernels import (blockmajor_window, grouped_group_size,
                                       identity_block_tables, loader,
                                       paged_attention_decode_fused,
                                       paged_attention_decode_fused_plain,
                                       paged_attention_decode_grouped,
                                       paged_attention_decode_grouped_plain,
                                       read_faults, slotmajor_window)
    B, L, KV, S = SERVE['max_batch'], SERVE['n_layers'], SERVE['n_kv_heads'], SERVE['max_seq_len']
    rep, Dh = SERVE['n_heads'] // KV, SERVE['d_model'] // SERVE['n_heads']
    gen = torch.Generator(device=dev).manual_seed(5)
    cache = {key: torch.randint(-128, 128, (L, B, S, KV, Dh), device=dev,
                                generator=gen, dtype=torch.int8)
             for key in ('k', 'v')}
    for key in ('k_scale', 'v_scale'):
        cache[key] = torch.rand(L, B, S, KV, device=dev, generator=gen) * 0.02 + 0.001
    q = torch.randn(B, KV, rep, Dh, device=dev, generator=gen).bfloat16()
    layer = L // 2
    read_faults(dev)
    results = {}
    cases = (('row 11 fill 512, blocks of 512', False, 512, 512, 512),
             ('row 12 fill 16, blocks of 32', True, 32, 32, 16),
             ('row 12 path G fill 512, blocks of 256', True, 512, 256, 512),
             ('row 12 path G fill 16, blocks of 256', True, 512, 256, 16))
    for label, grouped, cap, blk, fill in cases:
        window = blockmajor_window if grouped else slotmajor_window
        pool, sc = window(cache['k'], cache['v'], cache['k_scale'],
                          cache['v_scale'], cap, blk)
        if grouped:
            G = grouped_group_size(B, blk, kv_dh=KV * Dh, itemsize=1)
            tables = None
            run = lambda lens: paged_attention_decode_grouped(  # noqa: E731
                q, pool, sc, lens, layer, block_size=blk, group=G)
            plain = lambda lens: paged_attention_decode_grouped_plain(  # noqa: E731
                q, pool, sc, lens, layer, block_size=blk, group=G)
        else:
            G = 1
            tables = identity_block_tables(B, cap, blk, dev)
            run = lambda lens: paged_attention_decode_fused(  # noqa: E731
                q, pool, sc, tables, lens, layer, block_size=blk)
            plain = lambda lens: paged_attention_decode_fused_plain(  # noqa: E731
                q, pool, sc, tables, lens, layer, block_size=blk)
        dense = _dense_slots(pool, sc, layer, B, tables)
        path_lens = torch.full((B,), fill, dtype=torch.int32, device=dev)
        mixed = torch.randint(0, cap + 1, (B,), device=dev, generator=gen,
                              dtype=torch.int32)
        mixed[::9] = 0
        shares, worst = [], 0.0
        for lens in (path_lens, mixed, _edge_fills(B, cap, dev)):
            share, err = _hold_triple(label, run, plain, q, dense, lens)
            shares.append(share)
            worst = max(worst, err)
        faults = read_faults(dev)
        if faults:
            raise AssertionError(f'{label}: the kernel reported faults: {faults}')
        b, by = _attention_bound(path_lens, q, pool,
                                 0 if tables is None else tables.shape[1])
        ms = time_ms(lambda: run(path_lens), flush)
        if fill == cap:
            # a read of the same bytes by one PyTorch call: a float32 sum
            # over the layer's window codes (every position filled: the K
            # and V codes the kernel reads; their values as floats do not
            # matter, an integer sum is slower)
            codes = pool[layer].view(torch.float32)
            read_ms = time_ms(lambda: codes.sum(), flush)
            results[f'{label} read yardstick'] = dict(
                ms=read_ms, bytes=codes.numel() * 4)
            log(f'[attention] {label}: torch.sum over the same '
                f'{codes.numel() * 4} code bytes {read_ms:.4f} ms '
                f'({codes.numel() * 4 / read_ms / 1e9:.2f} TB/s); the kernel '
                f'{codes.numel() * 4 / ms / 1e9:.2f} TB/s of codes')
        results[label] = dict(
            ms=ms, bound_ms=b, bound_by=by, share_of_bound=b / ms,
            plain_ms=time_ms(lambda: plain(path_lens), flush),
            mixed_ms=time_ms(lambda: run(mixed), flush),
            max_abs_err=worst, worst_share_of_tolerance=max(shares),
            shape=[B, KV, rep, Dh, L, pool.shape[1], blk], fill=fill,
            group=G)
        log(f'[attention] {label}: {ms:.4f} ms (mixed fills '
            f'{results[label]["mixed_ms"]:.4f}), bound {b:.4f} ms ({by}), '
            f'share of bound {b / ms:.3f}, plain '
            f'{results[label]["plain_ms"]:.4f} ms; worst share of the '
            f'tolerance (path, mixed, edge fills) '
            f'{", ".join(f"{x:.3f}" for x in shares)}; two calls bit-equal')
        del pool, sc, dense, tables
    entries = loader.LIBRARIES['paged_attention'][1]
    lib = loader.library('paged_attention')
    if 'ppq_empty_launch' in entries:
        stream = loader.stream_of(dev)
        floor = time_ms(lambda: lib.ppq_empty_launch(stream), flush)
        results['launch floor'] = dict(ms=floor)
        log(f'[attention] launch floor (an empty kernel, event to event, '
            f'after the flush): {floor:.4f} ms')
    if 'ppq_paged_attention_occupancy' in entries:
        import ctypes
        for bf16, shallow, name in ((0, 0, 'int8'), (0, 1, 'int8 shallow'),
                                    (1, 0, 'bf16')):
            out = (ctypes.c_int * 5)()
            if lib.ppq_paged_attention_occupancy(bf16, rep, KV, shallow, out):
                raise AssertionError('paged attention: occupancy query failed')
            blocks, smem, stage, stages, warps = list(out)
            flight = blocks * warps * (stages - 1) * stage
            results[f'occupancy {name}'] = dict(
                blocks_per_sm=blocks, smem_per_block=smem,
                stage_bytes_per_warp=stage, stages=stages, warps=warps,
                bytes_in_flight_per_sm=flight)
            log(f'[attention] {name} pool, rep {rep}: {blocks} blocks an SM '
                f'(occupancy API), {smem} shared bytes a block, {warps} '
                f'warps each with {stages} stages of {stage} code bytes: up '
                f'to {flight} bytes of K and V in flight an SM')
    del cache, q
    torch.cuda.empty_cache()
    return results


def _buffered_tolerance(q, k, v, ks, vs, lens, kb, vb, ksb, vsb, step):
    """Row 13's context against another evaluation of its arithmetic: s sums
    Dh exact bf16 x code products in another order (delta = 2e-5 of its
    absolute mass, as for rows 11 and 12); p moves by 2 delta and may then
    round to the neighbouring bf16 number (2^-7 relative), so each term of
    acc moves by |p v_eff| (2^-7 + 4 delta), l by 4 delta, and the context
    acc / l by (sum |p v_eff| / l) (2^-7 + 8 delta). k, v: the slots'
    (B, S, KV, Dh) behind the tables, ks, vs (B, S, KV) or None; the buffer
    kb, vb (B, n, KV, Dh), ksb, vsb (B, KV, n) with columns [0, step]
    valid. Returns the (B, KV, rep, Dh) tolerance."""
    B, KV, rep, Dh = q.shape
    S, n = k.shape[1], kb.shape[1]
    dev = q.device
    ones = lambda m: torch.ones(B, m, KV, device=dev)  # noqa: E731
    kss = torch.cat([ones(S) if ks is None else ks,
                     ones(n) if ksb is None else ksb.transpose(1, 2)], 1)
    vss = torch.cat([ones(S) if vs is None else vs,
                     ones(n) if vsb is None else vsb.transpose(1, 2)], 1)
    keys = torch.cat([k.float(), kb.float()], 1)
    valid = torch.cat([torch.arange(S, device=dev)[None] < lens.long()[:, None],
                       (torch.arange(n, device=dev) <= step)[None].expand(B, n)],
                      1)[:, None, None, :]
    kt = kss.transpose(1, 2)[:, :, None] / np.sqrt(Dh)
    qf = q.float()
    s = torch.where(valid, torch.einsum('bkrd,bskd->bkrs', qf, keys) * kt,
                    -torch.inf)
    mass = torch.einsum('bkrd,bskd->bkrs', qf.abs(), keys.abs()) * kt
    delta = 2e-5 * torch.where(valid, mass, 0.0).amax(-1) + 1e-6
    del mass, keys
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    vals = torch.cat([v.float(), vb.float()], 1).abs() * vss[..., None]
    spread = torch.einsum('bkrs,bskd->bkrd', p, vals) / p.sum(-1)[..., None]
    return spread * (2.0 ** -7 + 8 * delta[..., None]) + 1e-6


def _composition(q, kv_bm, sc_bm, lens, layer, rblk, group, kb, vb, ksb, vsb,
                 step):
    """What the engine computes for the context of one layer at burst step
    `step`: row 12 over the repacked window, the buffer's columns below
    `step` and the step's own column (column `step`) as two more partial
    softmaxes, and merge_attention (serving/paged.py burst_forward_paged).
    kb, vb (B, n, KV, Dh); ksb, vsb (B, KV, n)."""
    from ppq_tpu_torch.kernels import (merge_attention,
                                       paged_attention_decode_grouped)
    from ppq_tpu_torch.serving.model import _pv_context, _qk_logits
    Dh = q.shape[-1]
    root = np.sqrt(Dh)
    frozen = paged_attention_decode_grouped(q, kv_bm, sc_bm, lens, layer,
                                            block_size=rblk, group=group)
    n = kb.shape[1]
    ids = torch.arange(n, device=q.device)[None, None, None, :]
    lb = _qk_logits(q[:, None], kb)[:, :, :, 0, :] * ksb[:, :, None, :]
    lb = torch.where(ids < step, lb / root, -1e30)
    m_b = lb.amax(-1)
    p_b = torch.exp(lb - m_b[..., None])
    acc_b = _pv_context((p_b * vsb[:, :, None, :])[:, :, :, None, :], vb)[:, 0]
    m_s = torch.einsum('bkrd,bkd->bkr', q.float(), kb[:, step].float()) \
        * ksb[:, :, step][:, :, None] / root
    acc_s = vb[:, step].float()[:, :, None, :] * vsb[:, :, step][:, :, None, None]
    return merge_attention([frozen, (acc_b, m_b, p_b.sum(-1)),
                            (acc_s.expand_as(frozen[0]), m_s,
                             torch.ones_like(m_s))])


def _hold_buffered(got, want, tol, what, factor=1.0):
    share = float(((got - want).abs() / (factor * tol)).max())
    if share > 1.0:
        raise AssertionError(f'{what}: off by {share:.2f} of the tolerance')
    return share


def kernels_paged(dev, flush, detail=False, measure=False):
    """Rows 16 and 13 at path G's shapes: the pool (16, 513, 2, 256, 1024)
    int8 and its f32 scales, 128 slots of 3 blocks (fill 512 and a burst of
    32). Row 16 writes a burst's 32 columns at position 512 (its timed
    case) and a 128-token prefill window at 0, each against its plain
    version bit for bit on the whole pool; the library column is index_put_
    of codes and scales (two calls, indices and values prepared outside the
    window). Row 13 reads one layer's strided planes of that pool and a
    32-column buffer through the engine's table width, at fills 512 and 16
    (and mixed fills), steps 31 and 0, against its plain version and the
    engine's composition on the same inputs, two calls bit-equal; timed at
    fill 512, step 31. The library column is that composition (row 12 over
    the repacked window, the buffer's products and merge_attention: several
    calls, the repack not included). `detail` (--attention): row 13 and the
    composition timed at both fills and steps, the composition also with
    its share of the burst's repack; with `measure`, the measurement
    build's row 13 beside it (`_row13_variants`)."""
    from ppq_tpu_torch.kernels import (paged_attention_decode_buffered,
                                       paged_attention_decode_buffered_plain,
                                       pool_write_inplace, pool_write_plain,
                                       read_faults)
    from ppq_tpu_torch.kernels.paged_attention import grouped_group_size
    from ppq_tpu_torch.serving.paged import BlockAllocator, gather_window
    B, L, KV = SERVE['max_batch'], SERVE['n_layers'], SERVE['n_kv_heads']
    S, Dh = SERVE['max_seq_len'], SERVE['d_model'] // SERVE['n_heads']
    rep, BLK, fill, T = SERVE['n_heads'] // KV, 256, 512, BURST
    MB = S // BLK
    NB = B * MB + 1
    gen = torch.Generator(device=dev).manual_seed(7)
    codes = lambda *s: torch.randint(-128, 128, s, device=dev, generator=gen,  # noqa: E731
                                     dtype=torch.int8)
    scales = lambda *s: torch.rand(*s, device=dev, generator=gen) * 0.02 + 0.001  # noqa: E731
    pool, scale = codes(L, NB, 2, BLK, KV * Dh), scales(L, NB, 2, KV, BLK)
    alloc = BlockAllocator(NB, B, MB, BLK)
    for slot in range(B):
        alloc.ensure(slot, fill + T)
    tables = torch.as_tensor(alloc.tables(), device=dev)
    kbuf, vbuf = codes(L, B, T, KV, Dh), codes(L, B, T, KV, Dh)
    ksb, vsb = scales(L, B, KV, T), scales(L, B, KV, T)
    wp = torch.full((B,), fill, dtype=torch.int32, device=dev)
    results = {}
    read_faults(dev)

    # row 16: the burst's window, then a prefill window (scales as the
    # prefill hands them: a transposed view)
    want = (pool.clone(), scale.clone())
    pool_write_inplace(pool, scale, kbuf, vbuf, ksb, vsb, tables, wp)
    pool_write_plain(*want, kbuf, vbuf, ksb, vsb, tables, wp)
    kp, vp = codes(L, B, 128, KV, Dh), codes(L, B, 128, KV, Dh)
    ksp = scales(L, B, 128, KV).transpose(2, 3)
    vsp = scales(L, B, 128, KV).transpose(2, 3)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    pool_write_inplace(pool, scale, kp, vp, ksp, vsp, tables, zero)
    pool_write_plain(*want, kp, vp, ksp, vsp, tables, zero)
    if not (torch.equal(pool, want[0]) and torch.equal(scale, want[1])):
        raise AssertionError('pool_write != plain on the whole pool')
    err = max(float((pool.to(torch.int16) - want[0].to(torch.int16)).abs().max()),
              float((scale - want[1]).abs().max()))
    # the library's yardstick: index_put_ on the pool as (L*NB, 2, BLK, KVDh)
    pos = wp.long()[:, None] + torch.arange(T, device=dev)
    rows = torch.gather(tables.long(), 1, pos // BLK)
    lrows = (torch.arange(L, device=dev)[:, None, None] * NB + rows[None])
    off = (pos % BLK)[None].expand_as(lrows)
    plane = torch.arange(2, device=dev)
    new_kv = torch.stack([kbuf.reshape(L, B, T, -1), vbuf.reshape(L, B, T, -1)], 3)
    new_sc = torch.stack([ksb.transpose(2, 3), vsb.transpose(2, 3)], 3)
    flat_kv, flat_sc = pool.view(L * NB, 2, BLK, -1), scale.view(L * NB, 2, KV, BLK)
    head = torch.arange(KV, device=dev)

    def library_pool():
        flat_kv.index_put_((lrows[..., None], plane, off[..., None]), new_kv)
        flat_sc.index_put_((lrows[..., None, None], plane[:, None], head,
                            off[..., None, None]), new_sc)

    moved = 2.0 * L * B * T * 2 * (KV * Dh + KV * 4) + 4 * B * (MB + 1)
    b, by = bound_ms(moved, 0.0)
    results['pool_write'] = dict(
        max_abs_err=err, shape=[L, NB, 2, BLK, KV * Dh], window=T, bound_ms=b,
        bound_by=by,
        ms=time_ms(lambda: pool_write_inplace(pool, scale, kbuf, vbuf, ksb, vsb,
                                              tables, wp), flush),
        prefill_window_128_ms=time_ms(lambda: pool_write_inplace(
            pool, scale, kp, vp, ksp, vsp, tables, zero), flush),
        plain_ms=time_ms(lambda: pool_write_plain(pool, scale, kbuf, vbuf, ksb,
                                                  vsb, tables, wp), flush),
        library_ms=time_ms(library_pool, flush))
    del want, kp, vp, ksp, vsp, new_kv, new_sc, lrows, off
    torch.cuda.empty_cache()

    # row 13: one layer's planes of the pool and a 32-column buffer
    layer = L // 2
    planes = (pool[layer, :, 0], pool[layer, :, 1], scale[layer, :, 0],
              scale[layer, :, 1])
    q = torch.randn(B, KV, rep, Dh, device=dev, generator=gen).bfloat16()
    kb, vb = kbuf[layer], vbuf[layer]                  # (B, T, KV, Dh)
    kb3, vb3 = kb.reshape(B, T, -1), vb.reshape(B, T, -1)
    ks1, vs1 = ksb[layer], vsb[layer]
    worst = worst_plain = worst_comp = 0.0
    inputs = {}
    for f in (fill, 16):
        # the engine's table width for the burst's positions and its frozen
        # read bucket (ServingEngine._table_width, _decode_bucket)
        width = 1
        while width * BLK < f + T:
            width *= 2
        bucket = 32
        while bucket < min(f, S):
            bucket *= 2
        tbl = tables[:, :min(width, MB)].contiguous()
        path_lens = torch.full((B,), f, dtype=torch.int32, device=dev)
        mixed = torch.randint(0, f + 1, (B,), device=dev, generator=gen,
                              dtype=torch.int32)
        mixed[::9] = 0
        dense = _dense_slots(pool, scale, layer, B, tbl)
        kv_bm, sc_bm, rblk = gather_window({'kv': pool, 'kv_scale': scale},
                                           tbl, read_limit=bucket)
        group = grouped_group_size(B, rblk, KV * Dh, 1, SERVE['n_heads'])
        for lens, step in ((path_lens, T - 1), (mixed, T - 1), (path_lens, 0)):
            args = (q, *planes, tbl, lens, kb3, vb3, ks1, vs1, step)
            got = paged_attention_decode_buffered(*args, block_size=BLK)
            if not torch.equal(got, paged_attention_decode_buffered(
                    *args, block_size=BLK)):
                raise AssertionError('paged_attention_buffered: two calls on '
                                     'the same inputs differ')
            want = paged_attention_decode_buffered_plain(*args, block_size=BLK)
            tol = _buffered_tolerance(q, *dense, lens, kb, vb, ks1, vs1, step)
            if lens is path_lens and step == T - 1:
                path_tol = tol
            worst_plain = max(worst_plain, _hold_buffered(
                got, want, tol, f'paged_attention_buffered at fill {f} '
                f'against its plain version'))
            # the composition folds the v scale into p, row 13 into the
            # values: two more bf16 roundings of each term
            comp = _composition(q, kv_bm, sc_bm, lens, layer, rblk, group, kb,
                                vb, ks1, vs1, step)
            worst_comp = max(worst_comp, _hold_buffered(
                got, comp, tol, f'paged_attention_buffered at fill {f} against '
                f'the composition', factor=2.0))
            worst = max(worst, float((got - want).abs().max()))
        inputs[f] = dict(tbl=tbl, lens=path_lens, kv_bm=kv_bm, sc_bm=sc_bm,
                         rblk=rblk, group=group, bucket=bucket, tol=path_tol)
        del dense
    faults = read_faults(dev)
    if faults:
        raise AssertionError(f'the kernels reported faults: {faults}')
    log(f'[kernel] paged_attention_buffered at fills {fill} and 16, steps 0 '
        f'and {T - 1}: worst share of the tolerance {worst_plain:.3f} against '
        f'its plain version, {worst_comp:.3f} of twice it against the '
        f'engine\'s composition; two calls bit-equal')

    def bound13(lens, step, width):
        tokens = float(lens.long().sum()) + B * (step + 1)
        moved = tokens * 2 * (KV * Dh + KV * 4) + B * KV * rep * Dh * (2 + 4) \
            + 4 * B * (width + 1)
        return bound_ms(moved, tokens * KV * rep * Dh * 4.0, BF16_OPS_PER_S)

    def row13(f, step):
        at = inputs[f]
        return lambda: paged_attention_decode_buffered(
            q, *planes, at['tbl'], at['lens'], kb3, vb3, ks1, vs1, step,
            block_size=BLK)

    def composition(f, step):
        at = inputs[f]
        return lambda: _composition(q, at['kv_bm'], at['sc_bm'], at['lens'],
                                    layer, at['rblk'], at['group'], kb, vb,
                                    ks1, vs1, step)

    step = T - 1
    at = inputs[fill]
    b, by = bound13(at['lens'], step, at['tbl'].shape[1])
    results['paged_attention_buffered'] = dict(
        max_abs_err=worst, shape=[B, KV, rep, Dh, NB, BLK, T], fill=fill,
        step=step, bound_ms=b, bound_by=by,
        worst_share_of_tolerance=worst_plain,
        worst_share_against_composition=worst_comp,
        ms=time_ms(row13(fill, step), flush),
        plain_ms=time_ms(lambda: paged_attention_decode_buffered_plain(
            q, *planes, at['tbl'], at['lens'], kb3, vb3, ks1, vs1, step,
            block_size=BLK), flush),
        # yardstick, several calls: the composition the engine runs instead
        library_ms=time_ms(composition(fill, step), flush))
    if detail:
        # --attention: both fills at steps 0 and 31, beside the engine's
        # composition with its share of the burst's repack (one
        # gather_window serves 32 steps of 16 layers)
        cells = {}
        for f in (fill, 16):
            at = inputs[f]
            repack = time_ms(lambda: gather_window(
                {'kv': pool, 'kv_scale': scale}, at['tbl'],
                read_limit=at['bucket']), flush)
            for s in (0, T - 1):
                b, by = bound13(at['lens'], s, at['tbl'].shape[1])
                comp = time_ms(composition(f, s), flush)
                cells[f'fill {f} step {s}'] = c = dict(
                    ms=time_ms(row13(f, s), flush), bound_ms=b,
                    composition_ms=comp, repack_ms_per_burst=repack,
                    composition_with_repack_ms=comp + repack / (T * L),
                    table_width=int(at['tbl'].shape[1]),
                    read_bucket=at['bucket'],
                    device_events=_device_events(
                        f'[attention] row 13 fill {f} step {s}', row13(f, s)),
                    composition_device_events=_device_events(
                        f'[attention] the composition fill {f} step {s}',
                        composition(f, s)))
                log(f'[attention] row 13 fill {f} + {s + 1} buffer columns: '
                    f'{c["ms"]:.4f} ms, bound {b:.4f} ms, share of bound '
                    f'{b / c["ms"]:.3f}; the composition {comp:.4f} ms, with '
                    f'its share of the repack ({repack:.4f} ms a burst over '
                    f'{T} steps x {L} layers) '
                    f'{c["composition_with_repack_ms"]:.4f} ms')
        results['row 13 cells'] = cells
        if measure:
            results['row 13 variants'] = _row13_variants(
                q, planes, inputs, fill, kb3, vb3, ks1, vs1, T, flush)
    log(f'[kernel] pool_write bit-equal to its plain version on the whole '
        f'pool; a 128-column prefill window '
        f'{results["pool_write"]["prefill_window_128_ms"]:.4f} ms; '
        f'paged_attention_buffered within its tolerance (row 11\'s delta, '
        f'one bf16 step of p, divided by l)')
    del pool, scale, inputs, kbuf, vbuf, ksb, vsb, q
    torch.cuda.empty_cache()
    return results


def _row13_variants(q, planes, inputs, fill, kb3, vb3, ks1, vs1, T, flush):
    """The measurement build's row 13 (`paged_attention_measure`) at path
    G's fills, step 31, beside the package's kernel: the copies and waits
    alone, and at fill 16 (a one-block table, so two warps a KV head) the
    one-warp-a-head layout, held against the plain version within its
    tolerance."""
    from ppq_tpu_torch.kernels import (loader,
                                       paged_attention_decode_buffered,
                                       paged_attention_decode_buffered_plain)
    from ppq_tpu_torch.kernels.paged_attention import _inv_sqrt
    lib = loader.library('paged_attention_measure')
    dev = q.device
    stream = loader.stream_of(dev)
    B, KV, rep, Dh = q.shape
    BLK = planes[0].shape[1]
    qb = q.contiguous()
    ctx = torch.empty((B, KV, rep, Dh), dtype=torch.float32, device=dev)
    fault = loader.fault_word(dev)
    out = {}
    for f in (fill, 16):
        at = inputs[f]
        step = T - 1
        args = (q, *planes, at['tbl'], at['lens'], kb3, vb3, ks1, vs1, step)

        def run(warps, copies):
            rc = lib.ppq_paged_attention_buffered_measure(
                qb.data_ptr(), *[t.data_ptr() for t in planes],
                at['tbl'].data_ptr(), at['lens'].data_ptr(), kb3.data_ptr(),
                vb3.data_ptr(), ks1.data_ptr(), vs1.data_ptr(),
                ctx.data_ptr(), fault.data_ptr(), B, KV, at['tbl'].shape[1],
                planes[0].shape[0], BLK, T, step, planes[0].stride(0),
                planes[1].stride(0), planes[2].stride(0), planes[3].stride(0),
                kb3.stride(0), vb3.stride(0), ks1.stride(0), vs1.stride(0),
                _inv_sqrt(Dh), warps, copies, stream)
            if rc:
                raise AssertionError(f'row 13 measurement build: {rc}')

        timed = {'kernel': time_ms(lambda: paged_attention_decode_buffered(
            *args, block_size=BLK), flush)}
        if f == 16:
            run(1, 0)
            share = _hold_buffered(
                ctx, paged_attention_decode_buffered_plain(*args,
                                                           block_size=BLK),
                at['tol'], 'row 13 one warp a head against its plain version')
            timed['one warp a head'] = time_ms(lambda: run(1, 0), flush)
            timed['one warp a head, share of the tolerance'] = share
        timed['copies only'] = time_ms(lambda: run(2, 1), flush)
        out[f'fill {f} step {step}'] = timed
        log(f'[attention] row 13 measurement build at fill {f}, step {step}: '
            + '; '.join(f'{k} {v:.4f}' for k, v in timed.items()))
    return out


class _PlainKernels:
    """Send the serving model through the kernels' plain versions on the
    card: the model looks its kernels up in their modules at call time."""

    def __enter__(self):
        from ppq_tpu_torch.kernels import (bank_write, paged_attention,
                                           pool_write, qmm, window_write)
        pa = paged_attention
        self.saved = [(pool_write, 'pool_write_inplace',
                       pool_write.pool_write_plain),
                      (qmm, 'qmm_int8', qmm.qmm_int8_plain),
                      (qmm, 'qmm_int4', qmm.qmm_int4_plain),
                      (qmm, 'qmm_gateup', qmm.qmm_gateup_plain),
                      (bank_write, 'bank_write_inplace',
                       bank_write.bank_write_plain),
                      (window_write, 'window_write_inplace',
                       window_write.window_write_plain),
                      (pa, 'paged_attention_decode_fused',
                       pa.paged_attention_decode_fused_plain),
                      (pa, 'paged_attention_decode_grouped',
                       pa.paged_attention_decode_grouped_plain)]
        self.saved = [(mod, name, getattr(mod, name), plain)
                      for mod, name, plain in self.saved]
        for mod, name, _, plain in self.saved:
            setattr(mod, name, plain)
        return self

    def __exit__(self, *exc):
        for mod, name, kernel, _ in self.saved:
            setattr(mod, name, kernel)


class _ShadowKernels:
    """The witness for the serving paths' loose KV-code limit: the model runs
    on the kernels, and every launch is also held against its plain version
    on that launch's own inputs. Given the same inputs, rows 8, 9 and 10
    must stay within their tolerance in every layer, the K (before the
    rotation) and V codes quantized from both wqkv results must differ on at
    most SERVE_CODE_SHARE_FIRST of entries in every layer, rows 11 and 12
    must stay within the attention tolerance (`_attention_tolerance`), and
    rows 14 and 15 must be bit-equal. What the full comparison shows beyond
    that in the later layers is then carried by the residual stream, not
    made there."""

    def __init__(self, cfg, tag='D'):
        self.cfg = cfg
        self.tag = tag
        self.kv_from = cfg.n_heads * cfg.head_dim
        self.qkv_width = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
        self.stats = {}
        self.code_share = []           # one entry per wqkv launch, in order
        self.copies = {}               # copy kernel -> launches held

    def _hold(self, name, got, want, tol):
        err = (got.float() - want).abs()
        lim = tol + (_bf16_step(want) if got.dtype == torch.bfloat16 else 0.0)
        ratio = float((err / lim).max())
        if ratio > 1.0:
            raise AssertionError(f'path {self.tag}, {name} on the path\'s own '
                                 f'inputs: off by {ratio:.2f} of the tolerance')
        entry = self.stats.setdefault(name, dict(
            launches=0, worst_share_of_tolerance=0.0,
            outputs_rounded_differently=0.0))
        entry['launches'] += 1
        entry['worst_share_of_tolerance'] = max(
            entry['worst_share_of_tolerance'], ratio)
        entry['outputs_rounded_differently'] += float(
            (got != want.to(got.dtype)).float().mean())

    def _codes(self, got, want, F, row_scale):
        """The K and V codes of a wqkv result and of its plain version."""
        from ppq_tpu_torch.serving.model import _kv_quant
        if F == self.qkv_width and row_scale is not None:
            heads = (got.shape[0], 1, 2 * self.cfg.n_kv_heads, self.cfg.head_dim)
            a, _ = _kv_quant(got[:, self.kv_from:].reshape(heads))
            b, _ = _kv_quant(want.to(got.dtype)[:, self.kv_from:].reshape(heads))
            self.code_share.append(float((a != b).float().mean()))

    def qmm_int8(self, x, w_int, scale, out_dtype=torch.bfloat16,
                 row_scale=None, residual=None):
        from ppq_tpu_torch.kernels.qmm import qmm_int8_plain
        got = self.kernels['qmm_int8'](x, w_int, scale, out_dtype, row_scale,
                                       residual)
        want = qmm_int8_plain(x, w_int, scale, torch.float32, row_scale, residual)
        tol, _ = _qmm_tolerance(x.bfloat16(), w_int, scale, row_scale, residual)
        D, F = w_int.shape
        self._hold(f'qmm_int8 {D}x{F}', got, want, tol)
        self._codes(got, want, F, row_scale)
        return got

    def qmm_int4(self, x, w_packed, scale, out_dtype=torch.bfloat16,
                 row_scale=None, residual=None):
        from ppq_tpu_torch.kernels.qmm import (qmm_int4_plain,
                                               unpack_int4_splithalf)
        got = self.kernels['qmm_int4'](x, w_packed, scale, out_dtype,
                                       row_scale, residual)
        want = qmm_int4_plain(x, w_packed, scale, torch.float32, row_scale,
                              residual)
        tol, _ = _qmm_tolerance(x.bfloat16(), unpack_int4_splithalf(w_packed),
                                scale, row_scale, residual)
        Dp, F = w_packed.shape
        self._hold(f'qmm_int4 {2 * Dp}x{F}', got, want, tol)
        self._codes(got, want, F, row_scale)
        return got

    def qmm_gateup(self, x, w_int, scale, out_dtype=torch.bfloat16,
                   row_scale=None):
        from ppq_tpu_torch.kernels.qmm import (qmm_gateup_plain,
                                               unpack_int4_splithalf)
        got = self.kernels['qmm_gateup'](x, w_int, scale, out_dtype, row_scale)
        want = qmm_gateup_plain(x, w_int, scale, torch.float32, row_scale)
        int4 = w_int.shape[0] * 2 == x.shape[1]
        w = unpack_int4_splithalf(w_int) if int4 else w_int
        self._hold('qmm_gateup_int4' if int4 else 'qmm_gateup', got, want,
                   _gateup_tolerance(x.bfloat16(), w, scale, row_scale))
        return got

    def _attention(self, name, q, got, want, dense, seq_lens):
        ratio, _ = _attention_tolerance(got, want, q, *dense, seq_lens)
        entry = self.stats.setdefault(name, dict(
            launches=0, worst_share_of_tolerance=0.0))
        entry['launches'] += 1
        entry['worst_share_of_tolerance'] = max(
            entry['worst_share_of_tolerance'], ratio)

    def paged_attention_decode_fused(self, q, kv_pool, kv_scale, block_tables,
                                     seq_lens, layer=None, *, block_size=128):
        from ppq_tpu_torch.kernels import paged_attention_decode_fused_plain
        got = self.kernels['paged_attention_decode_fused'](
            q, kv_pool, kv_scale, block_tables, seq_lens, layer,
            block_size=block_size)
        want = paged_attention_decode_fused_plain(
            q, kv_pool, kv_scale, block_tables, seq_lens, layer,
            block_size=block_size)
        self._attention('paged_attention_fused', q, got, want,
                        _dense_slots(kv_pool, kv_scale, layer, q.shape[0],
                                     block_tables), seq_lens)
        return got

    def paged_attention_decode_grouped(self, q, kv_bm, sc_bm, seq_lens,
                                       layer=None, *, block_size, group):
        from ppq_tpu_torch.kernels import paged_attention_decode_grouped_plain
        got = self.kernels['paged_attention_decode_grouped'](
            q, kv_bm, sc_bm, seq_lens, layer, block_size=block_size,
            group=group)
        want = paged_attention_decode_grouped_plain(
            q, kv_bm, sc_bm, seq_lens, layer, block_size=block_size,
            group=group)
        self._attention('paged_attention_grouped', q, got, want,
                        _dense_slots(kv_bm, sc_bm, layer, q.shape[0]),
                        seq_lens)
        return got

    def bank_write_inplace(self, bank, news, col):
        from ppq_tpu_torch.kernels import Bank, bank_write_plain
        want = Bank([t.clone() for t in bank.bufs])
        got = self.kernels['bank_write_inplace'](bank, news, col)
        bank_write_plain(want, news, col)
        if not all(torch.equal(a, b) for a, b in zip(got, want.bufs)):
            raise AssertionError(f'path {self.tag}: bank_write != plain on '
                                 f'the path\'s own inputs')
        self.copies['bank_write'] = self.copies.get('bank_write', 0) + 1
        return got

    def window_write_inplace(self, slabs, news, write_pos):
        from ppq_tpu_torch.kernels import window_write_plain
        want = [t.clone() for t in slabs]
        got = self.kernels['window_write_inplace'](slabs, news, write_pos)
        window_write_plain(want, news, write_pos)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f'path {self.tag}: window_write != plain on '
                                 f'the path\'s own inputs')
        self.copies['window_write'] = self.copies.get('window_write', 0) + 1
        return got

    def pool_write_inplace(self, kv_pool, sc_pool, k, v, ks, vs, tables,
                           write_pos, active=None):
        from ppq_tpu_torch.kernels import pool_write_plain
        want = (kv_pool.clone(), None if sc_pool is None else sc_pool.clone())
        got = self.kernels['pool_write_inplace'](kv_pool, sc_pool, k, v, ks,
                                                 vs, tables, write_pos, active)
        pool_write_plain(*want, k, v, ks, vs, tables, write_pos, active)
        if not all(a is None or torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f'path {self.tag}: pool_write != plain on '
                                 f'the path\'s own inputs')
        self.copies['pool_write'] = self.copies.get('pool_write', 0) + 1
        return got

    def __enter__(self):
        from ppq_tpu_torch.kernels import (bank_write, paged_attention,
                                           pool_write, qmm, window_write)
        self.modules = dict(qmm_int8=qmm, qmm_int4=qmm, qmm_gateup=qmm,
                            bank_write_inplace=bank_write,
                            window_write_inplace=window_write,
                            pool_write_inplace=pool_write,
                            paged_attention_decode_fused=paged_attention,
                            paged_attention_decode_grouped=paged_attention)
        self.kernels = {name: getattr(mod, name)
                        for name, mod in self.modules.items()}
        for name, mod in self.modules.items():
            setattr(mod, name, getattr(self, name))
        return self

    def __exit__(self, *exc):
        for name, mod in self.modules.items():
            setattr(mod, name, self.kernels[name])

    def report(self, steps, copies=('bank_write', 'window_write')):
        """Log and check what the run saw (the path's copy kernels among
        it); returns the summary."""
        L = self.cfg.n_layers
        if len(self.code_share) != L * steps or set(self.copies) != set(copies):
            raise AssertionError(
                f'path {self.tag} witness: {len(self.code_share)} wqkv launches '
                f'for {L} layers x {steps} steps, copies {self.copies}')
        by_layer = [max(self.code_share[li::L]) for li in range(L)]
        for entry in self.stats.values():
            if 'outputs_rounded_differently' in entry:
                entry['outputs_rounded_differently'] /= entry['launches']
        summary = dict(
            steps=steps, kernels=self.stats, copies_bit_equal=self.copies,
            kv_codes_differing_share_by_layer=[round(v, 6) for v in by_layer],
            limit=SERVE_CODE_SHARE_FIRST)
        log(f'[path {self.tag}] every launch against its plain version on the '
            f'same inputs: {json.dumps(summary)}')
        if max(by_layer) > SERVE_CODE_SHARE_FIRST:
            raise AssertionError(f'path {self.tag} witness: a layer\'s own KV '
                                 f'codes differ beyond the first layer\'s limit')
        return summary


def _serve_requests(vocab):
    """160 seeded requests for 128 slots: prompts of 8 to 120 tokens and one
    of 200 (longer than the 128 bucket: chunked prefill), 32 to 64 new
    tokens, every fifth with an eos, every seventh with its own sampling."""
    from ppq_tpu_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(SERVE_REQUESTS):
        length = 200 if i == 3 else int(rng.integers(8, 121))
        reqs.append(Request(
            i, [int(t) for t in rng.integers(1, vocab, size=length)],
            max_new_tokens=int(rng.integers(32, 65)),
            eos_id=int(rng.integers(1, vocab)) if i % 5 == 0 else None,
            sampling=SamplingParams(temperature=0.8, top_k=40, top_p=0.95)
            if i % 7 == 0 else None))
    return reqs


def _teacher_forced(engine, cache, cur, seq, forced, n_per_burst,
                    ragged=False, prefer_grouped=True):
    """Decode len(forced) steps from `cache` in bursts of n_per_burst, each
    step fed forced[i] whatever its logits say. Returns the per-step logits
    (on the card) and the cache."""
    from ppq_tpu_torch.serving.model import burst_forward
    seen = []
    cfg = engine.cfg
    for start in range(0, len(forced), n_per_burst):

        def select(logits, step, start=start):
            seen.append(logits)
            return forced[start + step]

        with torch.no_grad():
            burst_forward(engine.params, cache,
                          cur if start == 0 else forced[start - 1],
                          seq + start, n_per_burst, cfg, select,
                          s_limit=engine._decode_bucket(int(seq.max()) + len(forced)),
                          ragged=ragged, prefer_grouped=prefer_grouped)
    return seen, cache


def _written(cache, fills, n):
    """The K and V codes that n steps from `fills` wrote into a dense cache:
    {'k', 'v'} (L, B, n, KV, Dh)."""
    rows = fills.long()[:, None] + torch.arange(n, device=fills.device)
    slots = torch.arange(len(fills), device=fills.device)[:, None].expand_as(rows)
    return {key: cache[key][:, slots, rows] for key in ('k', 'v')}


def _pool_written(pools, tables, fills, n, kv_heads):
    """The same read out of paged pools through the block tables."""
    blk = pools['kv'].shape[3]
    pos = fills.long()[:, None] + torch.arange(n, device=fills.device)
    rows = torch.gather(tables.long(), 1, pos // blk)
    L = pools['kv'].shape[0]
    return {key: pools['kv'][:, rows, plane, pos % blk].reshape(
                L, len(fills), n, kv_heads, -1)
            for plane, key in enumerate(('k', 'v'))}


def _hold_against(tag, logits_a, toks_a, written_a, logits_b, written_b, fills,
                  n, code_share, code_step, path='D'):
    """Run b (teacher-forced with run a's tokens) against run a: logits
    within SERVE_LOGIT_TOL of the largest |logit|; b's argmax equal to a's
    token wherever a's top-1 margin exceeds that tolerance; the K and V codes
    that the steps wrote (`_written`) equal up to SERVE_CODE_SHARE_FIRST of
    entries in the first layer (whose inputs are identical) and code_share
    in any layer, by at most code_step codes."""
    worst = margin_flips = flips = 0.0
    for la, lb, tok in zip(logits_a, logits_b, toks_a):
        scale = float(la.abs().max())
        worst = max(worst, float((la - lb).abs().max()) / scale)
        differ = lb.argmax(-1) != tok.long()
        flips += int(differ.sum())
        top2 = la.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > SERVE_LOGIT_TOL * scale
        margin_flips += int((differ & clear).sum())
    step = 0.0
    exact = all(torch.equal(la, lb) for la, lb in zip(logits_a, logits_b))
    by_layer = None
    for key in ('k', 'v'):
        a = written_a[key].to(torch.int16)
        b = written_b[key].to(torch.int16)
        differ = (a != b).float().mean(dim=(1, 2, 3, 4))        # per layer
        by_layer = differ if by_layer is None else torch.maximum(by_layer, differ)
        step = max(step, float((a - b).abs().max()))
    codes_exact = max(by_layer.tolist()) == 0.0
    by_layer = [round(v, 5) for v in by_layer.tolist()]
    summary = dict(logits_max_diff_share_of_scale=worst, argmax_flips=int(flips),
                   argmax_flips_with_clear_margin=int(margin_flips),
                   steps=len(toks_a), slots=len(fills),
                   kv_codes_differing_share_by_layer=by_layer,
                   kv_codes_max_step=step, logits_bit_equal=exact,
                   written_codes_bit_equal=codes_exact,
                   limits=dict(logits=SERVE_LOGIT_TOL,
                               code_share_first_layer=SERVE_CODE_SHARE_FIRST,
                               code_share=code_share, code_step=code_step))
    log(f'[path {path}] {tag}: {json.dumps(summary)}')
    if worst > SERVE_LOGIT_TOL or margin_flips or step > code_step \
            or by_layer[0] > SERVE_CODE_SHARE_FIRST \
            or max(by_layer) > code_share:
        raise AssertionError(f'path {path} {tag}: beyond tolerance')
    return summary


def _serve_engine(tag, cfg, params):
    """The engine on the card, with the kernel matmuls and the folded
    norms on, and the bytes of its weights and KV cache."""
    from ppq_tpu_torch.serving import ServingEngine
    engine = ServingEngine(cfg, params)
    if not (cfg.use_kernel_matmul and cfg.norm_folded):
        raise AssertionError(f'path {tag}: the kernel matmuls or the folded '
                             f'norms are off')
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    cache_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    return engine, weight_bytes, cache_bytes


def _serve_run(tag, engine, reqs):
    """`run` over the requests: every one done within its budget, tokens in
    the vocabulary, eos respected. Returns its seconds and tokens."""
    vocab = engine.cfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs, sync_every=SERVE_SYNC)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    generated = 0
    for r in reqs:
        toks = r.generated
        if not r.done or not 1 <= len(toks) <= r.max_new_tokens:
            raise AssertionError(f'path {tag} request {r.rid}: done={r.done}, '
                                 f'{len(toks)} of {r.max_new_tokens} tokens')
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f'path {tag} request {r.rid}: a token outside '
                                 f'the vocabulary')
        if r.eos_id is not None and r.eos_id in toks[:-1]:
            raise AssertionError(f'path {tag} request {r.rid} ran past its eos')
        if r.eos_id is None and len(toks) != r.max_new_tokens:
            raise AssertionError(f'path {tag} request {r.rid} stopped early '
                                 f'without an eos')
        generated += len(toks)
    if any(r is not None for r in engine.slot_req):
        raise AssertionError(f'path {tag}: a slot is still taken after run')
    return dict(run_s=run_s, requests=len(reqs),
                requests_per_s=len(reqs) / run_s, generated_tokens=generated,
                generated_tokens_per_s=generated / run_s, sync_every=SERVE_SYNC)


def _decode_at(engine, fill, steps=64, repeats=3):
    """benchmark_decode at one fill, with its launches per decode step and
    the captures it made. Returns the result."""
    from ppq_tpu_torch.kernels import LAUNCHES
    before = dict(LAUNCHES)
    captures = engine.graph_captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = engine.benchmark_decode(steps=steps, burst=BURST,
                                     fill=fill, repeats=repeats)
    result['call_s'] = time.perf_counter() - t0
    # bank_write is launched once per decode step
    steps = LAUNCHES['bank_write'] - before['bank_write']
    result['decode_steps'] = steps
    result['launches_per_step'] = {
        k: (LAUNCHES[k] - v) / steps for k, v in before.items()
        if LAUNCHES[k] != v}
    result['captures'] = engine.graph_captures - captures
    if result['captures']:
        # the graph this call captured (the engine keeps them in order)
        result['launches_per_replay'] = \
            list(engine._graphs.values())[-1].launches_per_replay
    return result


def _serve_decode(engine, fills=(16, 512)):
    """benchmark_decode at a near-empty and a half-full cache, each with its
    bursts captured (the engine's default on the card: the first call of
    the burst shape runs uncaptured and captures it, the timed regions
    replay) and uncaptured, with the launches of each fill per decode
    step (uncaptured: one timed burst). The captured run must capture once
    and replay its graph in the timed regions."""
    decode = {}
    for fill in fills:
        captured = _decode_at(engine, fill)
        if captured['captures'] != 1:
            raise AssertionError(f'benchmark_decode at fill {fill} made '
                                 f'{captured["captures"]} captures, not 1')
        # uncaptured: one timed burst (each reads 1.3-2.0 s of host time)
        engine._capture = False
        try:
            captured['uncaptured'] = _decode_at(engine, fill, BURST, 1)
        finally:
            engine._capture = True
        decode[f'fill_{fill}'] = captured
    return decode


def _host_us(dev):
    """What the host pays to enqueue one small PyTorch operation: 2000
    in-place adds on 8 floats, which the card finishes faster than the host
    enqueues them."""
    tiny = torch.zeros(8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        tiny.add_(1.0)
    host_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return host_us


def _forced_start(tag, engine, dev, n, ragged=False, prefer_grouped=True):
    """The comparisons' start: a 128-token prefill of every slot, fills 8 to
    120, and a greedy burst of n steps from there. Returns the cache before
    the burst, the first token, the fills, and the burst's logits, tokens
    and cache."""
    from ppq_tpu_torch.serving.model import burst_forward, forward
    cfg = engine.cfg
    B, T = cfg.max_batch, cfg.prefill_buckets[0]
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(B, T)),
                              dtype=torch.int32, device=dev)
    fills = torch.as_tensor(rng.integers(8, 121, size=B), dtype=torch.int32,
                            device=dev)
    cache_a = engine._new_cache()
    with torch.no_grad():
        logits, _ = forward(
            engine.params, cache_a, prompts,
            torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev), cfg)
    if tuple(logits.shape) != (B, T, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f'path {tag}: prefill logits not finite or misshapen')
    cur = torch.gather(logits.argmax(-1), 1, (fills.long() - 1)[:, None])[:, 0] \
        .to(torch.int32)
    del logits
    start = {k: v.clone() for k, v in cache_a.items()}
    logits_a, toks_a = [], []

    def greedy(lg, step):
        logits_a.append(lg)
        toks_a.append(lg.argmax(-1).to(torch.int32))
        return toks_a[-1]

    with torch.no_grad():
        burst_forward(engine.params, cache_a, cur, fills, n, cfg, greedy,
                      s_limit=engine._decode_bucket(int(fills.max()) + n),
                      ragged=ragged, prefer_grouped=prefer_grouped)
    return start, cur, fills, logits_a, toks_a, cache_a


def _kernel_vs_plain(tag, engine, start, cur, fills, logits_a, toks_a,
                     cache_a, n, ragged=False, prefer_grouped=True):
    """The same teacher-forced steps through the kernels' plain versions."""
    from ppq_tpu_torch.kernels import LAUNCHES
    cache_c = {k: v.clone() for k, v in start.items()}
    before = dict(LAUNCHES)
    with _PlainKernels():
        logits_c, _ = _teacher_forced(engine, cache_c, cur, fills, toks_a, n,
                                      ragged, prefer_grouped)
    if LAUNCHES != before:
        raise AssertionError(f'path {tag}: the plain path launched a kernel')
    return _hold_against('kernel path against plain path', logits_a, toks_a,
                         _written(cache_a, fills, n), logits_c,
                         _written(cache_c, fills, n), fills, n,
                         **SERVE_KERNEL_VS_PLAIN, path=tag)


def _witness(tag, engine, start, cur, fills, toks, n, ragged=False,
             prefer_grouped=True):
    """Every launch of n teacher-forced steps against its plain version on
    that launch's own inputs (_ShadowKernels)."""
    cache_d = {k: v.clone() for k, v in start.items()}
    with _ShadowKernels(engine.cfg, tag) as shadow:
        _teacher_forced(engine, cache_d, cur, fills, toks[:n], n, ragged,
                        prefer_grouped)
    return shadow.report(n)


def _captured_vs_uncaptured(tag, engine, n=8, grouped=None, sampled=False):
    """One burst of n steps from the same state (every slot admitted with a
    seeded prompt of 8 to 120 tokens; every other slot sampling when
    `sampled`), as a replay of its CUDA graph and uncaptured, each from the
    same generator state: the tokens and every byte of the cache (dense:
    k, v and their scales; paged: the pools) must be equal. A sampled
    burst replayed twice in a row must draw other tokens on its sampled
    slots and the same on its greedy ones. grouped: the dense engine's
    read kernel (None: the engine's gate). Returns the summary."""
    from ppq_tpu_torch.serving import Request, SamplingParams
    cfg = engine.cfg
    B = cfg.max_batch
    engine._reset_cache()
    engine.slot_len[:] = 0
    engine.slot_req = [None] * B
    rng = np.random.default_rng(7)
    reqs = [Request(i, [int(t) for t in rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(8, 121)))],
                    max_new_tokens=4 * n,
                    sampling=SamplingParams(temperature=0.8, top_p=0.95)
                    if sampled and i % 2 else None) for i in range(B)]
    engine._admit_batch(list(enumerate(reqs)))
    cur = torch.tensor([r.generated[-1] for r in reqs], dtype=torch.int32,
                       device=engine.device)
    seq = engine._tensor(engine.slot_len, torch.int32)
    samp = engine._samp_arrays()
    fills = [int(f) for f in engine.slot_len]
    bucket = engine._decode_bucket(max(fills))
    if grouped is None and not engine._paged:
        grouped = engine._grouped_gate(fills, n, bucket)

    def burst():
        if engine._paged:
            return engine._paged_decode(n, cur, seq, list(range(B)), samp)[0]
        return engine._build_decode_burst(n, bucket, grouped)(
            engine.params, engine.cache, cur, seq, samp)[0]
    start = {k: v.clone() for k, v in engine.cache.items()}

    def restore():
        for k, v in start.items():
            engine.cache[k].copy_(v)
    captures = engine.graph_captures
    burst()                                   # uncaptured, then the capture
    restore()
    engine._generator.manual_seed(11)
    toks_c = burst()
    cache_c = {k: v.clone() for k, v in engine.cache.items()}
    differ = None
    if sampled:
        restore()
        again = burst()
        differ = int((again != toks_c)[:, 1::2].sum())
        if not differ or not torch.equal(again[:, 0::2], toks_c[:, 0::2]):
            raise AssertionError(f'path {tag}: two sampled replays drew '
                                 f'{differ} other tokens on the sampled slots '
                                 f'(or changed a greedy one)')
    restore()
    engine._capture = False
    try:
        engine._generator.manual_seed(11)
        toks_u = burst()
    finally:
        engine._capture = True
    same = torch.equal(toks_c, toks_u) and all(
        torch.equal(v, engine.cache[k]) for k, v in cache_c.items())
    made = engine.graph_captures - captures
    summary = dict(steps=n, kernel=('pool' if engine._paged else
                                    'grouped' if grouped else 'per-slot'),
                   sampled=sampled, captures=made, bit_equal=same,
                   sampled_tokens_differing_between_two_replays=differ)
    log(f'[path {tag}] captured burst against the uncaptured burst: '
        f'{json.dumps(summary)}')
    if not same or made != 1:
        raise AssertionError(f'path {tag}: the captured burst is not the '
                             f'uncaptured one ({summary})')
    engine.slot_len[:] = 0
    engine.slot_req = [None] * B
    if engine._paged:
        for slot in range(B):
            engine._alloc.release(slot)
    del start, cache_c
    torch.cuda.empty_cache()
    return summary


def _check_path_kernels(tag, launches):
    """The path launched each of its serving kernels and no other kernel
    (path M may or may not read a slot through the per-slot kernel: its
    fills decide)."""
    mine = PATH_KERNELS[tag]
    extra = PATH_MAY_LAUNCH.get(tag, ())
    if any(launches[k] <= 0 for k in mine) or any(
            launches[k] for k in launches if k not in mine + extra):
        raise AssertionError(f'path {tag} did not run exactly its kernels '
                             f'{mine}: {launches}')


def phase_path_d(dev):
    """The serving engine at full width with the dense cache read: run,
    benchmark_decode, then the comparisons and the profile outside the
    launch counts. Returns the raw parameters too (path E reuses them)."""
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.serving import LlamaConfig, init_llama_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**SERVE)
    # the dense read of the frozen cache (the engine's default on a card is
    # the ragged read, path E)
    cfg.use_ragged_attention = False
    reset_launches()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine, weight_bytes, cache_bytes = _serve_engine('D', cfg, params)

    # (1) run: two waves, chunked prefill, eos, per-request sampling
    reqs = _serve_requests(cfg.vocab_size)
    run = _serve_run('D', engine, reqs)
    launches_run = dict(LAUNCHES)
    # (4) benchmark_decode at a near-empty and a half-full cache
    decode = _serve_decode(engine)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    host_us = _host_us(dev)

    # ---- comparisons and the profile: these launches are not the path's --
    capture = [_captured_vs_uncaptured('D', engine),
               _captured_vs_uncaptured('D', engine, sampled=True)]
    n = 8
    start, cur, fills, logits_a, toks_a, cache_a = _forced_start('D', engine, dev, n)
    # (2) the burst against the same steps taken one by one
    cache_b = {k: v.clone() for k, v in start.items()}
    logits_b, _ = _teacher_forced(engine, cache_b, cur, fills, toks_a, 1)
    burst_vs_steps = _hold_against('burst of 8 against 8 single steps', logits_a,
                                   toks_a, _written(cache_a, fills, n), logits_b,
                                   _written(cache_b, fills, n), fills, n,
                                   **SERVE_BURST_VS_STEPS)
    del cache_b, logits_b
    # (3) the kernel path against the plain versions
    kernel_vs_plain = _kernel_vs_plain('D', engine, start, cur, fills,
                                       logits_a, toks_a, cache_a, n)
    # the witness: every launch of the real path against its plain version
    # on the launch's own inputs
    same_inputs = _witness('D', engine, start, cur, fills, toks_a, n)
    del cache_a, start, logits_a
    torch.cuda.empty_cache()
    profile = _profiles(engine, 'D')

    summary = dict(
        model=SERVE, weights_gib=weight_bytes / 2 ** 30,
        kv_cache_gib=cache_bytes / 2 ** 30, init_params_s=init_s, **run,
        launches_in_run=launches_run, decode=decode,
        host_us_per_small_launch=host_us,
        burst_vs_steps=burst_vs_steps, kernel_vs_plain=kernel_vs_plain,
        kernel_vs_plain_on_the_same_inputs=same_inputs,
        captured_vs_uncaptured=capture, profile=profile,
        peak_mem_gib_run_and_decode=peak)
    log(f'[path D] {json.dumps(summary)}')
    del engine
    torch.cuda.empty_cache()
    return launches, summary, params


def phase_path_e(dev, params):
    """The engine's default configuration on the card, on the first
    CUT_LAYERS of path D's weights:
    `use_ragged_attention` left None must resolve to True. run and
    benchmark_decode as in D, the kernel of each fill checked; then, outside
    the counts, the ragged burst against the dense burst on the same cache,
    the kernel path against the plain path, every launch against its plain
    version (the gate's grouped kernel over 8 steps, the per-slot kernel
    over 2), and the profile of each fill."""
    from ppq_tpu_torch.kernels import LAUNCHES, read_faults, reset_launches
    from ppq_tpu_torch.serving import LlamaConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**CUT_SERVE)
    params = _first_layers(params)
    reset_launches()
    engine, weight_bytes, cache_bytes = _serve_engine('E', cfg, params)
    if cfg.use_ragged_attention is not True:
        raise AssertionError('path E: use_ragged_attention did not resolve to '
                             'True on the card')
    reqs = _serve_requests(cfg.vocab_size)
    run = _serve_run('E', engine, reqs)
    launches_run = dict(LAUNCHES)
    decode = _serve_decode(engine)
    for fill, used, unused in ((16, 'paged_attention_grouped',
                                'paged_attention_fused'),
                               (512, 'paged_attention_fused',
                                'paged_attention_grouped')):
        per_step = decode[f'fill_{fill}']['launches_per_step']
        if per_step.get(used, 0) <= 0 or per_step.get(unused, 0):
            raise AssertionError(f'path E fill {fill}: expected {used} and not '
                                 f'{unused}, got {per_step}')
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    faults = read_faults(dev)
    if faults:
        raise AssertionError(f'path E: the kernels reported faults: {faults}')
    host_us = _host_us(dev)
    capture = [_captured_vs_uncaptured('E', engine, grouped=True),
               _captured_vs_uncaptured('E', engine, grouped=False),
               _captured_vs_uncaptured('E', engine, sampled=True)]

    n = 8
    B = cfg.max_batch
    rng = np.random.default_rng(1)
    rng.integers(1, cfg.vocab_size, size=(B, cfg.prefill_buckets[0]))
    host_fills = [int(f) for f in rng.integers(8, 121, size=B)]
    bucket = engine._decode_bucket(max(host_fills) + n)
    grouped = engine._grouped_gate(host_fills, n, bucket)
    start, cur, fills, logits_a, toks_a, cache_a = _forced_start(
        'E', engine, dev, n, ragged=True, prefer_grouped=grouped)
    if fills.tolist() != host_fills:
        raise AssertionError('path E: the comparisons\' fills moved')
    cache_b = {k: v.clone() for k, v in start.items()}
    logits_b, _ = _teacher_forced(engine, cache_b, cur, fills, toks_a, n,
                                  ragged=False)
    ragged_vs_dense = _hold_against(
        'ragged burst against the dense burst', logits_a, toks_a,
        _written(cache_a, fills, n), logits_b, _written(cache_b, fills, n),
        fills, n, **SERVE_RAGGED_VS_DENSE, path='E')
    del cache_b, logits_b
    kernel_vs_plain = _kernel_vs_plain('E', engine, start, cur, fills,
                                       logits_a, toks_a, cache_a, n,
                                       ragged=True, prefer_grouped=grouped)
    same_inputs = _witness('E', engine, start, cur, fills, toks_a, n,
                           ragged=True, prefer_grouped=grouped)
    same_inputs_fused = _witness('E', engine, start, cur, fills, toks_a, 2,
                                 ragged=True, prefer_grouped=False)
    del cache_a, start, logits_a
    torch.cuda.empty_cache()
    profile = _profiles(engine, 'E')
    summary = dict(
        model=CUT_SERVE, use_ragged_attention=cfg.use_ragged_attention,
        weights_gib=weight_bytes / 2 ** 30, kv_cache_gib=cache_bytes / 2 ** 30,
        **run, launches_in_run=launches_run, decode=decode,
        host_us_per_small_launch=host_us,
        comparisons_kernel=('grouped' if grouped else 'fused'),
        ragged_vs_dense=ragged_vs_dense, kernel_vs_plain=kernel_vs_plain,
        kernel_vs_plain_on_the_same_inputs=same_inputs,
        kernel_vs_plain_on_the_same_inputs_fused=same_inputs_fused,
        captured_vs_uncaptured=capture, profile=profile,
        peak_mem_gib_run_and_decode=peak)
    log(f'[path E] {json.dumps(summary)}')
    del engine
    torch.cuda.empty_cache()
    return launches, summary


def phase_path_f(dev):
    """INT4 weights (an INT8 lm_head), the ragged read, 128 slots: the
    configuration bench.py serves at weight_bits=4. benchmark_decode at fill
    16 and 512 and a short run; then, outside the counts, the captured burst
    against the uncaptured one, the kernel path against the plain path and
    every launch against its plain version. Returns the INT4 parameters too
    (path L's B=32 point reuses them)."""
    from ppq_tpu_torch.kernels import LAUNCHES, read_faults, reset_launches
    from ppq_tpu_torch.serving import LlamaConfig, init_llama_params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**dict(CUT_SERVE, weight_bits=4))
    reset_launches()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine, weight_bytes, cache_bytes = _serve_engine('F', cfg, params)
    if not (cfg.use_ragged_attention and 'w_packed' in engine.params['layers'][0]['wqkv']
            and 'w_int' in engine.params['lm_head']):
        raise AssertionError('path F: not INT4 weights with an INT8 lm_head '
                             'and the ragged read')
    decode = _serve_decode(engine)
    reqs = _serve_requests(cfg.vocab_size)[:INT4_REQUESTS]
    run = _serve_run('F', engine, reqs)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    faults = read_faults(dev)
    if faults:
        raise AssertionError(f'path F: the kernels reported faults: {faults}')
    capture = [_captured_vs_uncaptured('F', engine),
               _captured_vs_uncaptured('F', engine, sampled=True)]

    n = 8
    B = cfg.max_batch
    rng = np.random.default_rng(1)
    rng.integers(1, cfg.vocab_size, size=(B, cfg.prefill_buckets[0]))
    host_fills = [int(f) for f in rng.integers(8, 121, size=B)]
    grouped = engine._grouped_gate(host_fills, n,
                                   engine._decode_bucket(max(host_fills) + n))
    start, cur, fills, logits_a, toks_a, cache_a = _forced_start(
        'F', engine, dev, n, ragged=True, prefer_grouped=grouped)
    kernel_vs_plain = _kernel_vs_plain('F', engine, start, cur, fills,
                                       logits_a, toks_a, cache_a, n,
                                       ragged=True, prefer_grouped=grouped)
    same_inputs = _witness('F', engine, start, cur, fills, toks_a, n,
                           ragged=True, prefer_grouped=grouped)
    del cache_a, start, logits_a
    torch.cuda.empty_cache()
    profile = _profiles(engine, 'F')
    summary = dict(
        model=dict(CUT_SERVE, weight_bits=4),
        lm_head_bits=cfg.resolved_lm_head_bits,
        weights_gib=weight_bytes / 2 ** 30, kv_cache_gib=cache_bytes / 2 ** 30,
        init_params_s=init_s, **run, decode=decode,
        kernel_vs_plain=kernel_vs_plain,
        kernel_vs_plain_on_the_same_inputs=same_inputs,
        captured_vs_uncaptured=capture, profile=profile,
        peak_mem_gib_run_and_decode=peak)
    log(f'[path F] {json.dumps(summary)}')
    del engine
    torch.cuda.empty_cache()
    return launches, summary, params


def _paged_forced(engine, pools, tables, cur, seq, forced, n, observe=None):
    """n teacher-forced steps of one paged burst from `pools`, step i fed
    forced[i]. Returns the per-step logits (on the card)."""
    from ppq_tpu_torch.serving.paged import burst_forward_paged
    seen = []

    def select(logits, step):
        seen.append(logits)
        return forced[step]
    with torch.no_grad():
        burst_forward_paged(engine.params, pools, cur, seq, tables, n,
                            engine.cfg, select,
                            read_limit=engine._decode_bucket(int(seq.max())),
                            observe=observe)
    return seen


def _paged_slots(engine, tokens_each):
    """A fresh allocator with every slot's blocks through tokens_each, and
    the tables bucketed as the run loop buckets them."""
    from ppq_tpu_torch.serving.paged import BlockAllocator
    a = engine._alloc
    alloc = BlockAllocator(a.num_blocks, a.max_batch, a.max_blocks_per_seq,
                           a.block_size)
    for slot in range(a.max_batch):
        alloc.ensure(slot, tokens_each)
    return torch.as_tensor(
        alloc.tables()[:, :engine._table_width(tokens_each)],
        device=engine.device)


def _row13_on_the_burst(engine, dev, fill, n=8, probe=5):
    """One paged burst of n greedy steps at `fill` over the engine's pool
    (codes and scales seeded at random), in which, at step `probe` and for
    every layer, row 13 reads that step's query, the layer's pool planes,
    the tables, the fills and the burst's buffers with the step's own
    column written (step = probe). Each launch is held against its plain
    version and against the context the engine's composition produced
    (`_buffered_tolerance`, twice it for the composition). Also times the
    window repack of that burst. Returns the summary."""
    from ppq_tpu_torch.kernels import (paged_attention_decode_buffered,
                                       paged_attention_decode_buffered_plain)
    from ppq_tpu_torch.serving.paged import burst_forward_paged, gather_window
    cfg = engine.cfg
    B, blk = cfg.max_batch, engine._alloc.block_size
    pools = engine.cache
    gen = torch.Generator(device=dev).manual_seed(fill)
    pools['kv'].random_(-128, 128, generator=gen)
    pools['kv_scale'].uniform_(0.001, 0.02, generator=gen)
    tables = _paged_slots(engine, fill + n)
    seq = torch.full((B,), fill, dtype=torch.int32, device=dev)
    cur = torch.randint(1, cfg.vocab_size, (B,), device=dev, generator=gen,
                        dtype=torch.int32)
    shares = dict(plain=0.0, composition=0.0)

    def observe(at):
        if at['step'] != probe:
            return
        li, step = at['layer'], at['step']
        kb, vb = at['kbuf'].clone(), at['vbuf'].clone()
        kb[:, step], vb[:, step] = at['k'], at['v']
        ksb, vsb = at['ksb'].clone(), at['vsb'].clone()
        ksb[:, :, step], vsb[:, :, step] = at['ks'], at['vs']
        args = (at['q'], pools['kv'][li, :, 0], pools['kv'][li, :, 1],
                pools['kv_scale'][li, :, 0], pools['kv_scale'][li, :, 1],
                at['tables'], at['seq_lens'], kb.reshape(B, n, -1),
                vb.reshape(B, n, -1), ksb, vsb, step)
        got = paged_attention_decode_buffered(*args, block_size=blk)
        want = paged_attention_decode_buffered_plain(*args, block_size=blk)
        tol = _buffered_tolerance(
            at['q'], *_dense_slots(pools['kv'], pools['kv_scale'], li, B,
                                   at['tables']),
            at['seq_lens'], kb, vb, ksb, vsb, step)
        shares['plain'] = max(shares['plain'], _hold_buffered(
            got, want, tol, f'path G fill {fill}: row 13 against its plain '
            f'version'))
        shares['composition'] = max(shares['composition'], _hold_buffered(
            got, at['ctx'], tol, f'path G fill {fill}: row 13 against the '
            f'engine\'s composition', factor=2.0))

    with torch.no_grad():
        burst_forward_paged(engine.params, pools, cur, seq, tables, n, cfg,
                            lambda logits, step: logits.argmax(-1),
                            read_limit=engine._decode_bucket(fill),
                            observe=observe)
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    repack_ms = time_ms(
        lambda: gather_window(pools, tables, engine._decode_bucket(fill)), flush)
    del flush
    return dict(fill=fill, probe_step=probe, layers=cfg.n_layers,
                worst_share_of_tolerance=shares['plain'],
                worst_share_of_twice_it_against_composition=shares['composition'],
                repack_ms_per_burst=repack_ms)


def _reference_next_logits(params, cfg, seq, dev):
    """The dense forward over the whole sequence: its next token's logits."""
    from ppq_tpu_torch.serving.model import forward, init_kv_cache
    T = len(seq)
    cache = init_kv_cache(cfg, 1, dev)
    with torch.no_grad():
        logits, _ = forward(params, cache, torch.tensor([seq], dtype=torch.int32,
                                                        device=dev),
                            torch.arange(T, dtype=torch.int32, device=dev)[None],
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.full((1,), T, dtype=torch.int32, device=dev),
                            cfg)
    return logits[0, -1].float().cpu().numpy()


def _prefix_run(tag, engine, dev):
    """32 requests sharing a PAGED_PREFIX-token prefix with distinct 8-64
    token tails: the first arrives at 0, the other 31 10 ms later, while the
    first one's admission runs (a wave matches before it inserts, so they
    must come after it). Returns the requests and the counts and times."""
    from ppq_tpu_torch.serving import Request
    vocab = engine.cfg.vocab_size
    rng = np.random.default_rng(2)
    prefix = [int(t) for t in rng.integers(1, vocab, size=PAGED_PREFIX)]
    reqs = [Request(i, prefix + [int(t) for t in rng.integers(
                1, vocab, size=int(rng.integers(8, 65)))], max_new_tokens=16)
            for i in range(PAGED_PREFIX_REQUESTS)]
    admit = dict(s=0.0, calls=0)
    admit_batch = engine._admit_batch

    def timed(admits):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit_batch(admits)
        torch.cuda.synchronize()
        admit['s'] += time.perf_counter() - t0
        admit['calls'] += 1
    engine._admit_batch = timed
    free0 = engine._alloc.free_blocks
    t0 = time.perf_counter()
    engine.run(reqs, sync_every=SERVE_SYNC,
               arrivals=[0.0] + [0.01] * (PAGED_PREFIX_REQUESTS - 1))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del engine._admit_batch
    if not all(r.done and len(r.generated) == r.max_new_tokens for r in reqs):
        raise AssertionError(f'path {tag}: a prefix-run request did not finish')
    cache = engine.prefix_cache
    summary = dict(requests=len(reqs), run_s=run_s, admit_s=admit['s'],
                   admit_calls=admit['calls'])
    if cache is not None:
        held = len(cache.index)
        summary.update(hits=cache.hits, misses=cache.misses, cached_blocks=held)
        if engine._alloc.free_blocks != free0 - held:
            raise AssertionError(f'path {tag}: blocks leaked in the prefix run')
        cache.clear()
    if engine._alloc.free_blocks != engine._alloc.num_blocks - 1:
        raise AssertionError(f'path {tag}: blocks leaked in the prefix run')
    return reqs, summary


def _near_tie_tokens(tag, ref, got, params, cfg, dev):
    """test_engine_run_greedy_tokens' rule on the card: where a token
    differs, both candidates' logits (the dense forward over the sequence so
    far) lie within SERVE_LOGIT_TOL of the largest |logit| of each other and
    of the top, and that request's comparison ends there."""
    compared = equal = differing = 0
    for a, b in zip(ref, got):
        for i, (x, y) in enumerate(zip(a.generated, b.generated)):
            compared += 1
            if x == y:
                equal += 1
                continue
            differing += 1
            logits = _reference_next_logits(params, cfg,
                                            b.prompt + b.generated[:i], dev)
            scale = SERVE_LOGIT_TOL * np.abs(logits).max()
            if abs(logits[x] - logits[y]) > scale \
                    or logits.max() - min(logits[x], logits[y]) > scale:
                raise AssertionError(
                    f'path {tag}: request {b.rid} token {i} differs without a '
                    f'near-tie: tokens {x} / {y}, logits {logits[x]:.4f} / '
                    f'{logits[y]:.4f}, top {logits.max():.4f} (token '
                    f'{int(logits.argmax())}), tolerance {scale:.4f}')
            break
    return dict(tokens_compared=compared, tokens_equal=equal,
                requests_ending_at_a_near_tie=differing)


class _AllocRecorder:
    """Records the calls an engine makes on its block allocator, with what
    each returned (or raised), so that a Python free list given the same
    schedule can be held against them (`replay`)."""
    CALLS = ('ensure', 'release', 'adopt', 'retain', 'unref', 'tables',
             'slot_block_ids')

    def __init__(self, alloc):
        self.alloc, self.calls = alloc, []
        for name in self.CALLS:
            setattr(alloc, name, self._wrap(name, getattr(alloc, name)))

    def _wrap(self, name, fn):
        def call(*args):
            args = tuple(a if isinstance(a, (int, np.integer)) else
                         [int(b) for b in a] for a in args)
            try:
                out = fn(*args)
            except (MemoryError, ValueError) as e:
                self.calls.append((name, args, type(e)))
                raise
            self.calls.append((name, args, out.copy()
                               if isinstance(out, np.ndarray) else out))
            return out
        return call

    def close(self):
        for name in self.CALLS:
            self.alloc.__dict__.pop(name, None)

    def replay(self) -> int:
        from ppq_tpu_torch.serving.paged import BlockAllocator
        a = self.alloc
        python = BlockAllocator(a.num_blocks, a.max_batch,
                                a.max_blocks_per_seq, a.block_size,
                                native=False)
        for i, (name, args, want) in enumerate(self.calls):
            try:
                got = getattr(python, name)(*args)
            except (MemoryError, ValueError) as e:
                got = type(e)
            same = (np.array_equal(got, want) if isinstance(want, np.ndarray)
                    else got == want)
            if not same:
                raise AssertionError(f'allocator call {i} {name}{args}: '
                                     f'native {want}, Python {got}')
        if python.free_blocks != a.free_blocks:
            raise AssertionError(f'allocator: native {a.free_blocks} blocks '
                                 f'free, Python {python.free_blocks}')
        return len(self.calls)

    def timed(self, reps: int = 5) -> dict:
        """Host milliseconds of the recorded calls replayed on a new
        allocator of each backend, the two alternating, the best of `reps`
        each: the allocator's own time in the run."""
        from ppq_tpu_torch.serving.paged import BlockAllocator
        a, best = self.alloc, {}
        for _ in range(reps):
            for native in (True, False):
                b = BlockAllocator(a.num_blocks, a.max_batch,
                                   a.max_blocks_per_seq, a.block_size,
                                   native=native)
                calls = [(getattr(b, name), args)
                         for name, args, _ in self.calls]
                t0 = time.perf_counter()
                for fn, args in calls:
                    try:
                        fn(*args)
                    except (MemoryError, ValueError):
                        pass
                ms = (time.perf_counter() - t0) * 1e3
                best[b.backend] = min(best.get(b.backend, ms), ms)
        return best


def phase_path_g(dev, params):
    """Path G on the native block allocator (csrc/allocator.cc), which a
    user asks for with PPQ_TPU_NATIVE_ALLOC=1: every engine the path builds
    takes it (the port's default is the Python free list)."""
    saved = os.environ.get('PPQ_TPU_NATIVE_ALLOC')
    os.environ['PPQ_TPU_NATIVE_ALLOC'] = '1'
    try:
        return _path_g(dev, params)
    finally:
        if saved is None:
            del os.environ['PPQ_TPU_NATIVE_ALLOC']
        else:
            os.environ['PPQ_TPU_NATIVE_ALLOC'] = saved


def _path_g(dev, params):
    """Path D's model with the paged KV cache (bench.py's paged
    configuration): run over the 160 requests (the 200-token prompt through
    the chunked paged prefill) with every block back at its start,
    benchmark_decode at fill 16 and 512, and one burst at each fill on which
    row 13 reads every layer's inputs at one step; then, outside the counts,
    the prefix-cache run against the same requests with the cache off, the
    paged burst against path E's ragged burst on the same prompt KV, the
    kernel path against the plain path, every launch against its plain
    version, and the profile of each fill."""
    from ppq_tpu_torch.kernels import LAUNCHES, read_faults, reset_launches
    from ppq_tpu_torch.serving import LlamaConfig, ServingEngine
    from ppq_tpu_torch.serving.model import burst_forward, forward, init_kv_cache
    from ppq_tpu_torch.serving.paged import write_kv_window
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**SERVE, paged_kv=True)
    reset_launches()
    engine, weight_bytes, cache_bytes = _serve_engine('G', cfg, params)
    B, L, KV = cfg.max_batch, cfg.n_layers, cfg.n_kv_heads
    pool_shape = tuple(engine.cache['kv'].shape)
    if pool_shape != (L, B * cfg.max_seq_len // cfg.kv_block_size + 1, 2,
                      cfg.kv_block_size, KV * cfg.head_dim) \
            or cfg.kv_block_size != 256:
        raise AssertionError(f'path G: pool {pool_shape}, blocks of '
                             f'{cfg.kv_block_size}')
    free0 = engine._alloc.free_blocks
    # the engine's allocator is the native one; its run is held against the
    # Python free list given the same calls, and both are timed on them
    if engine._alloc.backend != 'native':
        raise AssertionError('path G: the native block allocator did not '
                             'build')
    recorder = _AllocRecorder(engine._alloc)
    reqs = _serve_requests(cfg.vocab_size)
    try:
        run = _serve_run('G', engine, reqs)
    finally:
        recorder.close()
    if engine._alloc is not recorder.alloc:
        raise AssertionError('path G: the engine replaced its allocator in run')
    if engine._alloc.free_blocks != free0:
        raise AssertionError(f'path G: {engine._alloc.free_blocks} blocks free '
                             f'after run, {free0} before')
    alloc_ms = recorder.timed()
    run['allocator'] = dict(backend=engine._alloc.backend,
                            calls_replayed=recorder.replay(),
                            tables_read=sum(c[0] == 'tables'
                                            for c in recorder.calls),
                            native_ms=alloc_ms['native'],
                            python_ms=alloc_ms['python'],
                            native_share_of_run=alloc_ms['native'] / 1e3
                            / run['run_s'],
                            python_share_of_run=alloc_ms['python'] / 1e3
                            / run['run_s'])
    launches_run = dict(LAUNCHES)
    decode = _serve_decode(engine)
    engine._reset_cache()
    row13 = [_row13_on_the_burst(engine, dev, fill) for fill in (16, 512)]
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    faults = read_faults(dev)
    if faults:
        raise AssertionError(f'path G: the kernels reported faults: {faults}')
    host_us = _host_us(dev)

    # ---- comparisons and the profile: these launches are not the path's --
    capture = [_captured_vs_uncaptured('G', engine),
               _captured_vs_uncaptured('G', engine, sampled=True)]
    engine._reset_cache()
    off_reqs, prefix_off = _prefix_run('G', engine, dev)
    del engine.cache
    torch.cuda.empty_cache()
    cached = ServingEngine(LlamaConfig(**SERVE, paged_kv=True,
                                       prefix_cache_blocks=PAGED_PREFIX_BLOCKS),
                           params)
    on_reqs, prefix_on = _prefix_run('G', cached, dev)
    del cached
    torch.cuda.empty_cache()
    if prefix_on['hits'] != PAGED_PREFIX_REQUESTS - 1 or prefix_on['misses'] != 1:
        raise AssertionError(f'path G: prefix cache {prefix_on}')
    ref_cfg = LlamaConfig(**SERVE)
    ref_cfg.use_kernel_matmul, ref_cfg.norm_folded = True, cfg.norm_folded
    prefix_tokens = _near_tie_tokens('G', off_reqs, on_reqs, engine.params,
                                     ref_cfg, dev)

    # the paged burst against path E's ragged burst on the same prompt KV
    n = 8
    T = cfg.prefill_buckets[0]
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(B, T)),
                              dtype=torch.int32, device=dev)
    fills = torch.as_tensor(rng.integers(8, 121, size=B), dtype=torch.int32,
                            device=dev)
    e_cfg = LlamaConfig(**SERVE)
    e_cfg.use_kernel_matmul, e_cfg.use_ragged_attention = True, True
    e_cfg.norm_folded = cfg.norm_folded
    dense = init_kv_cache(e_cfg, B, dev)
    with torch.no_grad():
        logits, _ = forward(
            engine.params, dense, prompts,
            torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev), e_cfg)
    cur = torch.gather(logits.argmax(-1), 1, (fills.long() - 1)[:, None])[:, 0] \
        .to(torch.int32)
    del logits
    engine.cache = engine._new_cache()
    tables = _paged_slots(engine, int(fills.max()) + n)
    # the prompt's codes and scales, copied into the pool through row 16
    write_kv_window(engine.cache, dense['k'][:, :, :T].contiguous(),
                    dense['v'][:, :, :T].contiguous(),
                    dense['k_scale'][:, :, :T].transpose(2, 3),
                    dense['v_scale'][:, :, :T].transpose(2, 3), tables,
                    torch.zeros(B, dtype=torch.int32, device=dev))
    start = {k: v.clone() for k, v in engine.cache.items()}
    bucket = engine._decode_bucket(int(fills.max()) + n)
    grouped = engine._grouped_gate(fills.tolist(), n, bucket)
    logits_e, toks_e = [], []

    def greedy(lg, step):
        logits_e.append(lg)
        toks_e.append(lg.argmax(-1).to(torch.int32))
        return toks_e[-1]
    with torch.no_grad():
        burst_forward(engine.params, dense, cur, fills, n, e_cfg, greedy,
                      s_limit=bucket, ragged=True, prefer_grouped=grouped)
    logits_g = _paged_forced(engine, engine.cache, tables, cur, fills, toks_e, n)
    written_g = _pool_written(engine.cache, tables, fills, n, KV)
    paged_vs_ragged = _hold_against(
        'paged burst against path E\'s ragged burst', logits_e, toks_e,
        _written(dense, fills, n), logits_g, written_g, fills, n,
        **SERVE_RAGGED_VS_DENSE, path='G')
    del dense, logits_e
    # the kernel path against the plain path, from the same pool
    plain_pools = {k: v.clone() for k, v in start.items()}
    before = dict(LAUNCHES)
    with _PlainKernels():
        logits_p = _paged_forced(engine, plain_pools, tables, cur, fills, toks_e,
                                 n)
    if LAUNCHES != before:
        raise AssertionError('path G: the plain path launched a kernel')
    kernel_vs_plain = _hold_against(
        'kernel path against plain path', logits_g, toks_e, written_g, logits_p,
        _pool_written(plain_pools, tables, fills, n, KV), fills, n,
        **SERVE_KERNEL_VS_PLAIN, path='G')
    del plain_pools, logits_p, logits_g
    # every launch against its plain version on that launch's own inputs
    engine.cache = start
    with _ShadowKernels(cfg, 'G') as shadow:
        _paged_forced(engine, engine.cache, tables, cur, fills, toks_e, n)
    same_inputs = shadow.report(n, copies=('bank_write', 'pool_write'))
    del start
    engine.cache = None
    torch.cuda.empty_cache()
    profile = _profiles(engine, 'G')
    summary = dict(
        model=dict(SERVE, paged_kv=True, kv_block_size=cfg.kv_block_size),
        pool=list(pool_shape), pool_blocks=pool_shape[1],
        weights_gib=weight_bytes / 2 ** 30, kv_pool_gib=cache_bytes / 2 ** 30,
        **run, free_blocks_before_and_after_run=free0,
        launches_in_run=launches_run, decode=decode, row13_on_the_burst=row13,
        host_us_per_small_launch=host_us,
        prefix_cache=dict(on=prefix_on, off=prefix_off, tokens=prefix_tokens),
        paged_vs_ragged=paged_vs_ragged, kernel_vs_plain=kernel_vs_plain,
        kernel_vs_plain_on_the_same_inputs=same_inputs,
        captured_vs_uncaptured=capture, profile=profile,
        peak_mem_gib_run_decode_row13=peak)
    log(f'[path G] {json.dumps(summary)}')
    del engine
    torch.cuda.empty_cache()
    return launches, summary


def _strict_planned_dispatch(engine, record):
    """Wrap the engine's planned dispatch so that its second call (the
    timed run of benchmark_serving; the first is its warm-up, which
    captures) runs under torch.cuda.set_sync_debug_mode('error') from its
    first dispatch to its download into pinned memory, and record its
    requests and the captures it made."""
    dispatch = engine._dispatch_planned
    calls = []

    def strict(requests, sync_every):
        calls.append(len(requests))
        if len(calls) != 2:
            return dispatch(requests, sync_every)
        captures = engine.graph_captures
        torch.cuda.set_sync_debug_mode('error')
        try:
            out = dispatch(requests, sync_every)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        record.update(requests=requests, captures=engine.graph_captures - captures)
        return out
    engine._dispatch_planned = strict
    return calls


def _b32_point(dev, cfg_fields, params, tag):
    """bench.py's B=32 decode point (`bench.py:484-499`): 32 slots,
    benchmark_decode(steps=64, burst=32, repeats=2) at fill 16, captured,
    then uncaptured."""
    from ppq_tpu_torch.serving import LlamaConfig, ServingEngine
    cfg = LlamaConfig(**dict(CUT_SERVE, max_batch=32, **cfg_fields))
    engine = ServingEngine(cfg, params)
    out = engine.benchmark_decode(steps=64, burst=32, repeats=2)
    engine._capture = False
    out['uncaptured'] = engine.benchmark_decode(steps=64, burst=32, repeats=2)
    log(f'[path L] B=32 {tag}: {json.dumps(out)}')
    del engine
    torch.cuda.empty_cache()
    return out


def phase_path_l(dev, params8, params4):
    """bench.py's serving track at its widths (`bench.py:396-499`): the
    paged INT8 engine of 128 slots on the first CUT_LAYERS of path D's
    weights,
    benchmark_serving(192, 64, 128, sync_every=128) on the planned loop
    (its timed run under the sync debug mode 'error' from its first
    dispatch to its download, with no capture), its tokens against the
    synchronous loop's on the same requests, benchmark_serving_mixed(192,
    64, 96, sync_every=32), the open-loop sweep at 0.6 / 0.8 / 0.95 of the
    mixed run's requests/s (windows of SWEEP_S seconds, bench.py's 22 cut
    to fit the smoke), every block back after each; then the B=32 decode
    points, INT4 (path F's weights) and INT8."""
    from ppq_tpu_torch.kernels import LAUNCHES, read_faults, reset_launches
    from ppq_tpu_torch.serving import LlamaConfig, Request, ServingEngine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**CUT_SERVE, paged_kv=True)
    params8, params4 = _first_layers(params8), _first_layers(params4)
    reset_launches()
    engine, weight_bytes, cache_bytes = _serve_engine('L', cfg, params8)
    free = engine._alloc.num_blocks - 1

    def blocks_back(what):
        if engine._alloc.free_blocks != free or any(
                r is not None for r in engine.slot_req):
            raise AssertionError(f'path L: {engine._alloc.free_blocks} of '
                                 f'{free} blocks free after {what}')

    record = {}
    calls = _strict_planned_dispatch(engine, record)
    t0 = time.perf_counter()
    serving = engine.benchmark_serving(n_requests=192, prompt_len=64,
                                       max_new_tokens=128, sync_every=128)
    serving['call_s'] = time.perf_counter() - t0
    del engine._dispatch_planned
    blocks_back('benchmark_serving')
    if calls != [1, 192] or record['captures']:
        raise AssertionError(f'path L: planned dispatches {calls}, '
                             f'{record.get("captures")} captures in the '
                             f'timed run')
    planned = record['requests']
    if not all(r.done and len(r.generated) == 128
               and all(0 <= t < cfg.vocab_size for t in r.generated)
               for r in planned):
        raise AssertionError('path L: a planned request did not generate '
                             'its budget of tokens in the vocabulary')
    # the same requests through the synchronous loop (arrivals all at 0)
    engine._reset_cache()
    synchronous = [Request(r.rid, r.prompt, max_new_tokens=r.max_new_tokens)
                   for r in planned]
    t0 = time.perf_counter()
    engine.run(synchronous, sync_every=128, arrivals=[0.0] * len(planned))
    sync_s = time.perf_counter() - t0
    blocks_back('the synchronous run')
    equal = sum(a.generated == b.generated for a, b in zip(planned, synchronous))
    if equal != len(planned):
        raise AssertionError(f'path L: {len(planned) - equal} planned requests '
                             f'differ from the synchronous loop\'s tokens')
    serving.update(sync_debug_mode='error', captures_in_timed_run=0,
                   tokens_equal_to_the_synchronous_loop=equal,
                   synchronous_loop_s=sync_s)
    log(f'[path L] benchmark_serving (planned): {json.dumps(serving)}')
    # what one admit wave costs: the batched prefill runs every slot's row
    admit_s = {}
    for count in (1, cfg.max_batch):
        engine._reset_cache()
        wave = [(slot, Request(slot, planned[slot].prompt, max_new_tokens=2))
                for slot in range(count)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._admit_batch(wave)
        torch.cuda.synchronize()
        admit_s[f'{count}_requests'] = time.perf_counter() - t0
        for slot in range(count):
            engine.slot_req[slot] = None
            engine.slot_len[slot] = 0
            engine._alloc.release(slot)
    engine._reset_cache()
    log(f'[path L] one admit wave (a prefill of 128 rows x 128 tokens), '
        f'seconds: {json.dumps(admit_s)}')

    t0 = time.perf_counter()
    mixed = engine.benchmark_serving_mixed(n_requests=192, mean_prompt=64,
                                           max_new_tokens=96, sync_every=32)
    mixed['call_s'] = time.perf_counter() - t0
    blocks_back('benchmark_serving_mixed')
    log(f'[path L] benchmark_serving_mixed: {json.dumps(mixed)}')
    cap = mixed['requests_per_sec']
    t0 = time.perf_counter()
    captures = engine.graph_captures
    sweep = engine.benchmark_serving_open_sweep(
        rates=[0.6 * cap, 0.8 * cap, 0.95 * cap], duration_s=SWEEP_S,
        mean_prompt=64, max_new_tokens=96, sync_every=32)
    sweep['call_s'] = time.perf_counter() - t0
    sweep['captures'] = engine.graph_captures - captures
    blocks_back('the open-loop sweep')
    log(f'[path L] benchmark_serving_open_sweep: {json.dumps(sweep)}')
    for key, result in (('benchmark_serving', serving),
                        ('benchmark_serving_mixed', mixed)):
        for k in SERVING_KEYS[key]:
            if not (np.isfinite(result[k]) and result[k] > 0):
                raise AssertionError(f'path L {key}: {k} = {result.get(k)}')
    if len(sweep['rate_points']) != 3:
        raise AssertionError('path L: the sweep has not three points')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    summary = dict(model=dict(CUT_SERVE, paged_kv=True,
                              kv_block_size=cfg.kv_block_size),
                   weights_gib=weight_bytes / 2 ** 30,
                   kv_pool_gib=cache_bytes / 2 ** 30,
                   graphs=len(engine._graphs), captures=engine.graph_captures,
                   serving=serving, admit_wave_s=admit_s,
                   serving_mixed=mixed, open_sweep=sweep,
                   sweep_window_s=SWEEP_S, peak_mem_gib_serving=peak)
    del engine, planned, synchronous
    torch.cuda.empty_cache()
    summary['decode_b32'] = {
        'int4': _b32_point(dev, dict(weight_bits=4), params4, 'INT4'),
        'int8': _b32_point(dev, {}, params8, 'INT8')}
    launches = dict(LAUNCHES)
    faults = read_faults(dev)
    if faults:
        raise AssertionError(f'path L: the kernels reported faults: {faults}')
    log(f'[path L] {json.dumps(summary)}')
    return launches, summary


def main_serving() -> int:
    """Path L alone: bench.py's serving track on the port."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from ppq_tpu_torch.serving import LlamaConfig, init_llama_params
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['qmm', 'kv_write', 'paged_attention'])
    params8 = init_llama_params(LlamaConfig(**CUT_SERVE), seed=0)
    params4 = init_llama_params(LlamaConfig(**dict(CUT_SERVE, weight_bits=4)),
                                seed=0)
    launches, _ = phase_path_l(dev, params8, params4)
    log(f'[launches] path L {json.dumps(launches)}')
    _check_path_kernels('L', launches)
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _profile_burst(engine, fill, n=8, tag='D', captured=True):
    """Where a decode step's time goes: torch.profiler over one burst of n
    steps at the given cache fill, a replay of its CUDA graph or (captured
    False) uncaptured, on the engine's own cache: the device's busy share
    of the wall time and the top kernels by device time. Returns the
    summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = engine.cfg.max_batch
    engine._reset_cache()
    cache = engine.cache
    tokens = torch.zeros((B,), dtype=torch.int32, device=engine.device)
    seq = torch.full((B,), fill, dtype=torch.int32, device=engine.device)
    bucket = engine._decode_bucket(fill)
    if engine._paged:
        # every slot's blocks through fill + n, as benchmark_decode has them
        for slot in range(B):
            engine._alloc.ensure(slot, fill + n)
        tables = torch.as_tensor(
            engine._alloc.tables()[:, :engine._table_width(fill + n)],
            device=engine.device)
        paged = engine._build_decode_burst_paged(n, read_limit=bucket)

        def burst():
            return paged(engine.params, cache, tokens, seq, tables)[0].cpu()
    else:
        dense = engine._build_decode_burst(
            n, bucket, grouped=engine._grouped_gate([fill] * B, n, bucket))

        def burst():
            return dense(engine.params, cache, tokens, seq)[0].cpu()
    mode = 'captured' if captured else 'uncaptured'
    engine._capture = captured
    try:
        burst()
        t0 = time.perf_counter()
        burst()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            burst()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        engine._capture = True
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if engine._paged:
        for slot in range(B):
            engine._alloc.release(slot)
    if not rows:
        log(f'[profile {tag} fill {fill} {mode}] the profiler recorded no '
            f'device time: not measured')
        return dict(unprofiled_ms_per_step=unprofiled_ms)
    busy_us = sum(t for _, t, _ in rows)
    ours = {name: sum(t for k, t, _ in rows if pattern in k)
            for name, pattern in (('qmm (int8, int4 and gate-up)', 'qmm'),
                                  ('paged_attention (rows 11, 12)',
                                   'paged_decode_kernel'),
                                  ('bank_write', 'bank_write_kernel'),
                                  ('window_write', 'window_write_kernel'),
                                  ('pool_write', 'pool_write_kernel'))}
    log(f'[profile {tag} fill {fill} {mode}] burst of {n}: '
        f'{unprofiled_ms:.3f} ms/step unprofiled, {wall_us / n / 1e3:.3f} '
        f'ms/step under the profiler, device busy {busy_us / n / 1e3:.3f} '
        f'ms/step, busy share of the profiled wall time '
        f'{busy_us / wall_us:.3f}, of the unprofiled step '
        f'{busy_us / n / 1e3 / unprofiled_ms:.3f}; device events per step '
        f'{sum(c for _, _, c in rows) / n:.0f}; the port\'s kernels ms/step '
        f'{json.dumps({k: round(v / n / 1e3, 4) for k, v in ours.items()})}')
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f'[profile {tag} fill {fill} {mode}]   {t / n / 1e3:8.3f} ms/step  '
            f'{count / n:7.1f} calls  {key[:90]}')
    return dict(unprofiled_ms_per_step=unprofiled_ms,
                device_busy_ms_per_step=busy_us / n / 1e3,
                busy_share_profiled=busy_us / wall_us,
                busy_share_unprofiled=busy_us / n / 1e3 / unprofiled_ms,
                device_events_per_step=sum(c for _, _, c in rows) / n,
                ours_ms_per_step={k: v / n / 1e3 for k, v in ours.items()})


def _profiles(engine, tag):
    """The burst profile at fill 16 and 512, captured and uncaptured."""
    return {f'fill_{fill}_{mode}': _profile_burst(engine, fill, tag=tag,
                                                  captured=mode == 'captured')
            for fill in (16, 512) for mode in ('captured', 'uncaptured')}


def _plain_delegate(tensor, cfg):
    """Fake-quant through the kernels' plain versions (ppq_fake_quant's
    argument handling, the plain arithmetic)."""
    from ppq_tpu_torch.kernels import floating_quant_plain, linear_quant_plain
    if not isinstance(tensor, torch.Tensor) or not tensor.is_floating_point() \
            or not cfg.is_active:
        return tensor
    scale = np.asarray(cfg.scale, np.float32)
    if cfg.policy.floating:
        return floating_quant_plain(
            tensor, scale, cfg.exponent_bits,
            cfg.num_of_bits - 1 - cfg.exponent_bits, cfg.quant_min,
            cfg.quant_max, cfg.channel_axis if cfg.policy.per_channel else None)
    offset = (np.asarray(cfg.offset, np.float32) if cfg.policy.asymmetric
              else np.zeros_like(scale))
    axis = cfg.channel_axis if cfg.policy.per_channel else None
    return linear_quant_plain(tensor, scale, offset, cfg.quant_min,
                              cfg.quant_max, cfg.rounding, axis)


def _plain_forward(graph, x_dev):
    """The simulated forward with every fake-quant through the plain
    versions."""
    from ppq_tpu_torch import TorchExecutor
    executor = TorchExecutor(graph)
    for op in graph.operations.values():
        if hasattr(op, 'config'):
            for cfg in op.config:
                executor.register_quantize_delegate(cfg, _plain_delegate)
    return executor.forward(x_dev)[0]


def _data():
    shape = [CALIB_BATCH, 3, IMAGE, IMAGE]
    rng = np.random.RandomState(0)
    loader = [rng.randn(*shape).astype(np.float32) for _ in range(CALIB_STEPS)]
    x_eval = np.random.RandomState(1).randn(*shape).astype(np.float32)
    return shape, loader, x_eval


def _fp32_forward(shape, x_dev):
    """The model as it was before any quantization or finetuning (the zoo
    graph is seeded), in fp32: the reference that a finetuned graph is held
    against."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.zoo import resnet18
    return TorchExecutor(resnet18(input_shape=shape)).forward(x_dev)[0]


def _forward_vs(graph, x_dev, y_fp32):
    """(simulated forward, its SNR against y_fp32, top-1 agreement), checked
    for shape and finiteness."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    y = TorchExecutor(graph).forward(x_dev)[0]
    for name, out in (('quantized', y), ('fp32', y_fp32)):
        if tuple(out.shape) != (CALIB_BATCH, 1000) or not torch.isfinite(out).all():
            raise AssertionError(f'{name} forward: shape {tuple(out.shape)}, '
                                 f'finite {bool(torch.isfinite(out).all())}')
    return (y, float(torch_snr_error(y, y_fp32)),
            float((y.argmax(-1) == y_fp32.argmax(-1)).float().mean()))


class _BlockLog(logging.Handler):
    """Collects what the training passes report per block through the
    package's logger: 'LSQ <block>: loss a → b (accepted | rolled back)'."""

    LINE = re.compile(r'^(\S+) (TrainableBlock\(.*\)): loss (\S+) → (\S+) '
                      r'\((accepted|rolled back)\)$')

    def __init__(self):
        super().__init__()
        self.history = []

    def emit(self, record):
        found = self.LINE.match(record.getMessage())
        if found:
            self.history.append(dict(
                block=found.group(2), pre_loss=float(found.group(3)),
                post_loss=float(found.group(4)),
                accepted=found.group(5) == 'accepted'))

    def __enter__(self):
        logging.getLogger('ppq_tpu_torch').addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger('ppq_tpu_torch').removeHandler(self)


def _inputs_taken_once(pass_cls):
    """pass_cls with every block's quantized inputs taken in one sweep
    before any block is tuned, as the JAX package takes them: the
    comparison that shows what taking them block by block buys."""
    from ppq_tpu_torch.quantization.algorithm import BlockBuilder

    class InputsTakenOnce(pass_cls):
        once = None

        def collect_inputs(self, graph, blocks, batches, executor):
            if self.once is None:
                every = BlockBuilder(graph).build(self.block_size)
                self.once = pass_cls.collect_inputs(graph, every, batches,
                                                    executor)
            return self.once

    return InputsTakenOnce


def _log_history(tag, history):
    """Accepted blocks improved their loss, the others did not (the logged
    losses carry four digits, so equal counts as either)."""
    for h in history:
        log(f'[{tag}] {h["block"]}: loss {h["pre_loss"]:.4e} -> '
            f'{h["post_loss"]:.4e} '
            f'({"accepted" if h["accepted"] else "rolled back"})')
        if (h['post_loss'] > h['pre_loss']) if h['accepted'] \
                else (h['post_loss'] < h['pre_loss']):
            raise AssertionError(f'{tag}: a block was accepted without '
                                 f'improving, or rolled back though it did')
    if not history:
        raise AssertionError(f'{tag}: no block was processed')


def phase_path_b(dev, kl_graph):
    """Blockwise finetuning on the INT8 graph: LSQ inside quantize_graph,
    then BiasCorrection and RoundTuning through manop."""
    from ppq_tpu_torch import TargetPlatform, manop, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization.optim import (BiasCorrectionPass,
                                                  LearnedStepSizePass,
                                                  RoundTuningPass)
    from ppq_tpu_torch.zoo import resnet18
    shape, loader, x_eval = _data()
    loader = loader[:TRAIN_BATCHES]
    x_dev = torch.as_tensor(x_eval, device=dev)
    y_fp32 = _fp32_forward(shape, x_dev)
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    base = resnet18(input_shape=shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_graph(base, loader, calib_steps=TRAIN_BATCHES,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    graph = resnet18(input_shape=shape)
    setting = QuantizationSettingFactory.default_setting()
    setting.lsq_optimization = True
    setting.lsq_optimization_setting.steps = LSQ_STEPS
    with _BlockLog() as lsq_log:
        t0 = time.perf_counter()
        quantize_graph(graph, loader, calib_steps=TRAIN_BATCHES,
                       platform=TargetPlatform.TPU_INT8, setting=setting,
                       verbose=False)
        torch.cuda.synchronize()
        lsq_s = time.perf_counter() - t0
    bias = BiasCorrectionPass(steps=TRAIN_BATCHES)
    manop(base, bias, calib_dataloader=loader, verbose=False)
    tuning = RoundTuningPass(steps=ROUND_STEPS, calib_steps=TRAIN_BATCHES)
    t0 = time.perf_counter()
    manop(kl_graph, tuning, calib_dataloader=loader, verbose=False)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    y, snr_lsq, top1_lsq = _forward_vs(graph, x_dev, y_fp32)
    _, snr_bias, top1_bias = _forward_vs(base, x_dev, y_fp32)
    _, snr_round, top1_round = _forward_vs(kl_graph, x_dev, y_fp32)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)

    # comparisons: these launches are not the path's
    plain = resnet18(input_shape=shape)
    quantize_graph(plain, loader, calib_steps=TRAIN_BATCHES,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    _, snr_before, top1_before = _forward_vs(plain, x_dev, y_fp32)
    capture = dict(
        lsq=_captured_vs_uncaptured_pass(
            'lsq int8', plain, lambda: LearnedStepSizePass(
                steps=CAPTURE_STEPS, calib_steps=TRAIN_BATCHES),
            loader, CAPTURE_STEPS),
        bias_correction=_captured_vs_uncaptured_pass(
            'bias correction', plain,
            lambda: BiasCorrectionPass(steps=TRAIN_BATCHES), loader,
            CAPTURE_STEPS),
        round_tuning=_captured_vs_uncaptured_pass(
            'round tuning', plain, lambda: RoundTuningPass(
                steps=CAPTURE_STEPS, calib_steps=TRAIN_BATCHES),
            loader, CAPTURE_STEPS))
    manop(plain, _inputs_taken_once(LearnedStepSizePass)(
        steps=LSQ_STEPS, calib_steps=TRAIN_BATCHES),
        calib_dataloader=loader, verbose=False)
    _, snr_once, _ = _forward_vs(plain, x_dev, y_fp32)
    _log_history('lsq int8', lsq_log.history)
    _log_history('bias correction', bias.history)
    if not torch.equal(y, _plain_forward(graph, x_dev)):
        raise AssertionError('path B: kernel-path forward != plain-path forward')
    # accepted blocks only improve their loss, so LSQ must not worsen the
    # output against fp32 (5 % for blocks tuned one by one on cached inputs)
    if not snr_lsq <= snr_before * 1.05:
        raise AssertionError(f'LSQ worsened the SNR: {snr_before} -> {snr_lsq}')
    if not (snr_bias < SNR_INT8_BOUND and snr_round < SNR_INT8_BOUND):
        raise AssertionError(f'SNR after BiasCorrection {snr_bias}, after '
                             f'RoundTuning {snr_round}')
    blocks = len(lsq_log.history)
    summary = dict(
        quantize_s=quant_s, quantize_with_lsq_s=lsq_s, lsq_blocks=blocks,
        lsq_steps=blocks * LSQ_STEPS,
        lsq_blocks_accepted=sum(h['accepted'] for h in lsq_log.history),
        # caches and the loss evaluations before and after each block count in
        lsq_s_per_step_whole_pass=(lsq_s - quant_s) / (blocks * LSQ_STEPS),
        snr_before_lsq=snr_before, snr_after_lsq=snr_lsq,
        snr_after_lsq_with_block_inputs_taken_once=snr_once,
        top1_before_lsq=top1_before, top1_after_lsq=top1_lsq,
        snr_after_bias_correction=snr_bias, top1_bias_correction=top1_bias,
        bias_blocks_accepted=sum(h['accepted'] for h in bias.history),
        round_tuning_s=round_s, snr_after_round_tuning=snr_round,
        top1_round_tuning=top1_round, plain_path_equal=True,
        captured_vs_uncaptured=capture,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f'[path B] {json.dumps(summary)}')
    return launches, summary, graph, loader


def phase_path_c(dev):
    """The TPU_FP8 platform: quantize, simulate, finetune with frozen
    scales."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, manop, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization import qfunction
    from ppq_tpu_torch.quantization.optim import LearnedStepSizePass
    from ppq_tpu_torch.zoo import resnet18
    shape, loader, x_eval = _data()
    loader = loader[:TRAIN_BATCHES]
    x_dev = torch.as_tensor(x_eval, device=dev)
    x_train = torch.as_tensor(loader[0], device=dev)
    y_fp32 = _fp32_forward(shape, x_dev)
    y_fp32_train = _fp32_forward(shape, x_train)
    torch.cuda.reset_peak_memory_stats()

    # row 6's launches by body, counted where qfunction calls the wrapper
    # (one LAUNCHES key holds both); a call inside a capture launches
    # nothing (its replays do, without calling the wrapper: LSQ's steps)
    bodies = dict(channelwise=0, tensorwise=0)
    in_captures = dict(channelwise=0, tensorwise=0)
    floating_quant = qfunction.floating_quant

    def by_body(x, scale, e_bits, m_bits, qmin, qmax, channel_axis=None):
        if x.is_cuda and x.numel():
            counts = (in_captures if torch.cuda.is_current_stream_capturing()
                      else bodies)
            counts['tensorwise' if channel_axis is None
                   else 'channelwise'] += 1
        return floating_quant(x, scale, e_bits, m_bits, qmin, qmax,
                              channel_axis)

    qfunction.floating_quant = by_body
    reset_launches()
    graph = resnet18(input_shape=shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_graph(graph, loader, calib_steps=TRAIN_BATCHES,
                   platform=TargetPlatform.TPU_FP8,
                   setting=QuantizationSettingFactory.fp8_setting(),
                   verbose=False)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    executor = TorchExecutor(graph)
    bodies_before = dict(bodies)
    y = executor.forward(x_dev)[0]
    torch.cuda.synchronize()
    # the bodies of one forward, counted on this untimed one: the timed
    # loop runs without the counting wrapper, and its row 6 launches must
    # be n_fwd times these
    bodies_per_forward = {k: bodies[k] - v for k, v in bodies_before.items()}
    qfunction.floating_quant = floating_quant
    before_fwd = dict(LAUNCHES)
    n_fwd = 10
    t0 = time.perf_counter()
    for _ in range(n_fwd):
        y = executor.forward(x_dev)[0]
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / n_fwd
    per_forward = {k: (LAUNCHES[k] - v) / n_fwd for k, v in before_fwd.items()
                   if LAUNCHES[k] != v}
    timed_row6 = LAUNCHES['floating_quant'] - before_fwd['floating_quant']
    if timed_row6 != n_fwd * sum(bodies_per_forward.values()):
        raise AssertionError(f'path C: row 6 launched {timed_row6} times in '
                             f'{n_fwd} forwards, one forward called its '
                             f'bodies {bodies_per_forward}')
    for k, v in bodies_per_forward.items():
        bodies[k] += n_fwd * v
    qfunction.floating_quant = by_body
    _, snr, top1 = _forward_vs(graph, x_dev, y_fp32)
    snr_train = _forward_vs(graph, x_train, y_fp32_train)[1]
    lsq = LearnedStepSizePass(is_scale_trainable=False, steps=LSQ_STEPS,
                              calib_steps=TRAIN_BATCHES)
    t0 = time.perf_counter()
    manop(graph, lsq, calib_dataloader=loader, verbose=False)
    torch.cuda.synchronize()
    lsq_s = time.perf_counter() - t0
    y_tuned, snr_tuned, top1_tuned = _forward_vs(graph, x_dev, y_fp32)
    snr_train_tuned = _forward_vs(graph, x_train, y_fp32_train)[1]
    launches = dict(LAUNCHES)
    qfunction.floating_quant = floating_quant
    # every LSQ step after a block's first is a replay of the block's
    # capture: its row 6 launches are the capture's tensorwise calls
    if in_captures['channelwise']:
        raise AssertionError(f'path C: a capture held channelwise row 6 '
                             f'calls: {in_captures}')
    replayed = sum(h['replays'] * h['launches_per_replay'].get(
        'floating_quant', 0) for h in lsq.history)
    if any(h['replays'] != LSQ_STEPS - 1 for h in lsq.history):
        raise AssertionError(f'path C: LSQ replays a block '
                             f'{[h["replays"] for h in lsq.history]}, not '
                             f'{LSQ_STEPS - 1}')
    bodies['tensorwise'] += replayed
    if sum(bodies.values()) != launches['floating_quant']:
        raise AssertionError(f'path C: row 6 launched {launches["floating_quant"]} '
                             f'times, its bodies were called {bodies}')

    # comparisons: these launches are not the path's
    plain = resnet18(input_shape=shape)
    quantize_graph(plain, loader, calib_steps=TRAIN_BATCHES,
                   platform=TargetPlatform.TPU_FP8,
                   setting=QuantizationSettingFactory.fp8_setting(),
                   verbose=False)
    y_again = TorchExecutor(plain).forward(x_dev)[0]
    if not torch.equal(y, y_again):
        raise AssertionError('path C: two FP8 quantizations differ')
    if not torch.equal(y, _plain_forward(plain, x_dev)):
        raise AssertionError('path C: kernel-path forward != plain-path forward')
    if not torch.equal(y_tuned, _plain_forward(graph, x_dev)):
        raise AssertionError('path C: finetuned kernel-path forward != '
                             'plain-path forward')
    capture = _captured_vs_uncaptured_pass(
        'lsq fp8', plain, lambda: LearnedStepSizePass(
            is_scale_trainable=False, steps=CAPTURE_STEPS,
            calib_steps=TRAIN_BATCHES), loader, CAPTURE_STEPS)
    manop(plain, _inputs_taken_once(LearnedStepSizePass)(
        is_scale_trainable=False, steps=LSQ_STEPS, calib_steps=TRAIN_BATCHES),
        calib_dataloader=loader, verbose=False)
    _, snr_once, _ = _forward_vs(plain, x_dev, y_fp32)
    _log_history('lsq fp8', lsq.history)
    if not snr < SNR_FP8_BOUND:
        raise AssertionError(f'FP8 forward SNR too large: {snr}')
    if not snr_tuned <= snr * 1.05:
        raise AssertionError(f'LSQ worsened the FP8 SNR: {snr} -> {snr_tuned}')
    scales = sorted({float(np.asarray(c.scale).reshape(-1)[0])
                     for op in plain.operations.values() if hasattr(op, 'config')
                     for c in op.config if c.policy.floating and c.has_scale})
    blocks = len(lsq.history)
    summary = dict(
        quantize_s=quant_s, forward_ms=fwd_s * 1e3,
        forward_img_per_s=CALIB_BATCH / fwd_s, launches_per_forward=per_forward,
        floating_quant_by_body=bodies,
        floating_quant_by_body_per_forward=bodies_per_forward,
        snr_fp8=snr, top1_agree_fp8=top1, floating_scales=scales,
        lsq_pass_s=lsq_s, lsq_blocks=blocks, lsq_steps=blocks * LSQ_STEPS,
        lsq_blocks_accepted=sum(h['accepted'] for h in lsq.history),
        # caches and the loss evaluations before and after each block count in
        lsq_s_per_step_whole_pass=lsq_s / (blocks * LSQ_STEPS),
        snr_fp8_after_lsq=snr_tuned, top1_agree_after_lsq=top1_tuned,
        snr_fp8_after_lsq_with_block_inputs_taken_once=snr_once,
        snr_fp8_on_a_training_batch=snr_train,
        snr_fp8_on_a_training_batch_after_lsq=snr_train_tuned,
        plain_path_equal=True, captured_vs_uncaptured=capture,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f'[path C] {json.dumps(summary)}')
    return launches, summary, graph, loader


def phase_lsq_steps(tag, graph, loader, scales_trainable, profile_first,
                    n=4):
    """What one LSQ step costs, block by block, captured and uncaptured:
    the pass's own block trainer (`LearnedStepSizePass.block_trainer`:
    forward through the compiled block, loss, backward, Adam), n steps after
    2 (captured: the first runs as it is and captures, the second is the
    first replay), with the wall time and the kernels' launches of those n
    steps; for the first block also a torch.profiler breakdown of both.
    Runs after the paths' counts are read and writes nothing back to the
    graph."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.kernels import LAUNCHES
    from ppq_tpu_torch.quantization.algorithm import BlockBuilder
    from ppq_tpu_torch.quantization.optim.training import (
        LearnedStepSizePass, _unbaked_parameters)
    executor = TorchExecutor(graph)
    lsq = LearnedStepSizePass(calib_steps=TRAIN_BATCHES,
                              is_scale_trainable=scales_trainable)
    totals = {True: [0.0, {}], False: [0.0, {}]}
    with _unbaked_parameters(graph):
        blocks = BlockBuilder(graph).build(lsq.block_size)
        qt, fp = lsq.collect_caches(graph, blocks, loader, None, executor)
        for index, block in enumerate(blocks):
            feeds = [lsq._feed(block, a, b) for a, b in zip(qt, fp)]
            for captured in (True, False):
                trainer = lsq.block_trainer(graph, block, executor.device,
                                            capture=captured)

                def step(i):
                    trainer.step(feeds[i % len(feeds)])

                for i in range(2):
                    step(i)
                torch.cuda.synchronize()
                before = dict(LAUNCHES)
                t0 = time.perf_counter()
                for i in range(n):
                    step(i)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                per_step = {k: (LAUNCHES[k] - v) / n
                            for k, v in before.items() if LAUNCHES[k] != v}
                how = 'captured' if captured else 'uncaptured'
                if captured and trainer.step.replays != n + 1:
                    raise AssertionError(f'lsq step {tag}: {n + 2} captured '
                                         f'steps made {trainer.step.replays} '
                                         f'replays')
                log(f'[lsq step {tag}] {block} {how}: '
                    f'{seconds / n * 1e3:.3f} ms/step, launches per step '
                    f'{json.dumps(per_step)}')
                totals[captured][0] += seconds
                for k, v in per_step.items():
                    totals[captured][1][k] = totals[captured][1].get(k, 0) + v
                if index == 0 and profile_first:
                    _profile_steps(f'{tag} {how}', block, step, n=6)
                del trainer
    for captured, (total_s, launches) in totals.items():
        log(f'[lsq step {tag}] {"captured" if captured else "uncaptured"}, '
            f'mean over {len(blocks)} blocks: '
            f'{total_s / (n * len(blocks)) * 1e3:.3f} ms/step, launches per '
            f'step {json.dumps(_per_block(launches, len(blocks)))}')


def _per_block(launches, blocks):
    return {k: v / blocks for k, v in launches.items()}


def _same_state(a, b) -> bool:
    """Nested dicts of tensors (and numbers) equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            _same_state(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def _captured_vs_uncaptured_pass(tag, graph, make_pass, loader, steps):
    """make_pass() through manop on two copies of a quantized graph, one
    with every step after a block's first a CUDA-graph replay (the
    default) and one uncaptured: the trained tensors and Adam's state of
    every block, the decisions, and the graph's parameters and scales
    afterwards must be equal bit for bit."""
    import copy
    from ppq_tpu_torch import manop
    from ppq_tpu_torch.interop import quantization_configs_of
    runs = []
    for capture in (True, False):
        g = copy.deepcopy(graph)
        p = make_pass()
        p.capture, p.keep_state = capture, True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manop(g, p, calib_dataloader=loader, verbose=False)
        torch.cuda.synchronize()
        runs.append((g, p, time.perf_counter() - t0))
    (ga, pa, sa), (gb, pb, sb) = runs
    if len(pa.history) != len(pb.history) or not pa.history:
        raise AssertionError(f'{tag}: {len(pa.history)} blocks captured, '
                             f'{len(pb.history)} uncaptured')
    replays = []
    for ha, hb in zip(pa.history, pb.history):
        for key in ('state', 'pre_loss', 'post_loss', 'accepted'):
            if not _same_state(ha.get(key), hb.get(key)):
                raise AssertionError(f'{tag} {ha["block"]}: {key} differs '
                                     f'captured and uncaptured')
        if 'replays' in ha:
            if ha['replays'] != steps - 1 or hb['replays'] != 0:
                raise AssertionError(f'{tag} {ha["block"]}: {ha["replays"]} '
                                     f'replays of {steps} steps captured, '
                                     f'{hb["replays"]} uncaptured')
            replays.append(ha['replays'])
    for name, var in ga.variables.items():
        if var.is_parameter and not np.array_equal(
                np.asarray(var.value), np.asarray(gb.variables[name].value)):
            raise AssertionError(f'{tag}: parameter {name} differs captured '
                                 f'and uncaptured')
    ca, cb = quantization_configs_of(ga), quantization_configs_of(gb)
    for key, entry in ca.items():
        for part in ('scale', 'offset'):
            if not np.array_equal(np.asarray(entry[part]),
                                  np.asarray(cb[key][part])):
                raise AssertionError(f'{tag}: {key} {part} differs captured '
                                     f'and uncaptured')
    result = dict(blocks=len(pa.history), steps=steps,
                  replays_per_block=replays, seconds_captured=sa,
                  seconds_uncaptured=sb, bit_equal=True)
    log(f'[{tag}] captured vs uncaptured: {json.dumps(result)}')
    return result


def _profile_steps(tag, block, step, n):
    """Where an LSQ step's device time goes: torch.profiler over n steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only; an annotation such as Optimizer.step repeats
    # the time of the kernels under it
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(('Optimizer.', 'ProfilerStep'))]
    if not rows:
        log(f'[profile lsq {tag}] the profiler recorded no device time: '
            f'not measured')
        return
    busy_us = sum(t for _, t, _ in rows)
    ours = sum(t for k, t, _ in rows if 'anonymous namespace' in k and (
        'fake_quant' in k or 'bwd_' in k or 'sum_partials' in k
        or 'floating' in k))
    # row 5's launches, either layout
    row5 = sum(c for k, _, c in rows if 'bwd_channel_kernel' in k
               or 'bwd_columns_kernel' in k)
    log(f'[profile lsq {tag}] {block}: {n} steps: wall '
        f'{wall_us / n / 1e3:.3f} ms/step, device busy '
        f'{busy_us / n / 1e3:.3f} ms/step, busy share '
        f'{busy_us / wall_us:.3f}; the fake-quant kernels (forward, backward, '
        f'partial sums) {ours / n / 1e3:.3f} ms/step, {ours / busy_us:.3f} of '
        f'device time; device events per step '
        f'{sum(c for _, _, c in rows) / n:.1f}, of them row 5 {row5 / n:.1f}')
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:14]:
        log(f'[profile lsq {tag}]   {t / n / 1e3:8.3f} ms/step  '
            f'{count / n:6.1f} calls  {key[:90]}')


@contextlib.contextmanager
def _observer_path():
    """quantize_graph's calibration through the observers (path A's),
    not the compiled pass that is the package's default (path H's)."""
    from ppq_tpu_torch.core import PPQ_TPU_CONFIG
    saved = PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR
    PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = False
    try:
        yield
    finally:
        PPQ_TPU_CONFIG.PREFER_COMPILED_EXECUTOR = saved


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
    shape, loader, x_eval = _data()
    torch.cuda.reset_peak_memory_stats()     # not the kernels phase's peak

    # path A is the observer path (path H the compiled calibration)
    reset_launches()
    graph = resnet18(input_shape=shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _observer_path():
        quantize_graph(graph, loader, calib_steps=CALIB_STEPS,
                       platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    after_pct = dict(LAUNCHES)

    kl_graph = resnet18(input_shape=shape)
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation_setting.calib_algorithm = 'kl'
    t0 = time.perf_counter()
    with _observer_path():
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
    y_plain = _plain_forward(graph, x_dev)
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
    if not (snr < SNR_INT8_BOUND and snr_kl < SNR_INT8_BOUND):
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
    log(f'[path A] {json.dumps(summary)}')
    return launches, summary, graph, kl_graph


# ------------------------------------------------------------------ path H
# the compiled executor's runners: bench.py's headline (batch 256, chains
# of 4 after stem_space_to_depth) and its 'highest' and 'bf16' runners
SIM_BATCH, SIM_CHAIN, SIM_REPEATS, SIM_CPU_IMAGES = 256, 4, 5, 8
# the compiled percentile sums 16 per-batch quantiles in float32 where the
# observer sums them in float64: at most 15 float32 roundings of the running
# sum, and one of the scale each way (15 * 2^-24 + 2^-23 relative)
PCT_SUM_BOUND = 15 * 2.0 ** -24 + 2.0 ** -23


class _GraphShadow:
    """Rows 1-3 inside a captured graph, each launch held against its plain
    version on that launch's own inputs (in the style of _ShadowKernels).
    While a capture is recorded, every call of the fake-quant and histogram
    wrappers also records clones of its input and output, which the capture
    holds: after a replay they are what the kernel read and wrote in it.
    `check()` runs the plain versions on them."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        from ppq_tpu_torch.executor import compile as compiled
        from ppq_tpu_torch.quantization import qfunction
        self._saved = (qfunction.linear_quant, compiled.histogram)
        linear_quant, histogram = self._saved

        def shadow_quant(x, scale, offset, qmin, qmax, rounding,
                         channel_axis=None, codes=False):
            y = linear_quant(x, scale, offset, qmin, qmax, rounding,
                             channel_axis, codes)
            if torch.cuda.is_current_stream_capturing():
                self.records.append((
                    'fake_quant_tensorwise' if channel_axis is None
                    else 'fake_quant_channelwise', x.clone(), y.clone(),
                    (scale, offset, qmin, qmax, rounding, channel_axis,
                     codes)))
            return y

        def shadow_histogram(x, scale, bins, absolute=True, out=None):
            y = histogram(x, scale, bins, absolute, out)
            if torch.cuda.is_current_stream_capturing():
                self.records.append(('histogram', x.clone(), y.clone(),
                                     (scale, bins, absolute)))
            return y

        qfunction.linear_quant, compiled.histogram = (shadow_quant,
                                                      shadow_histogram)
        return self

    def __exit__(self, *exc):
        from ppq_tpu_torch.executor import compile as compiled
        from ppq_tpu_torch.quantization import qfunction
        qfunction.linear_quant, compiled.histogram = self._saved

    def check(self, tag):
        from ppq_tpu_torch.kernels import histogram_plain, linear_quant_plain
        torch.cuda.synchronize()
        held = {}
        for name, x, y, args in self.records:
            if name == 'histogram':
                want = histogram_plain(x, *args)
                same = torch.equal(y, want)
            else:
                want = linear_quant_plain(x, *args)
                same = torch.equal(y.view(torch.int32),
                                   want.view(torch.int32))
            if not same:
                raise AssertionError(f'{tag}: a {name} launch inside the '
                                     f'captured graph differs from its '
                                     f'plain version')
            held[name] = held.get(name, 0) + 1
        self.records.clear()
        return held


def _int64_conv(x_codes, w_codes, op):
    """A convolution of integer codes in int64 (unfold, then the product)."""
    x, w = x_codes.to(torch.int64), w_codes.to(torch.int64)
    p = [int(v) for v in op.attributes.get('pads', [0, 0, 0, 0])]
    s = [int(v) for v in op.attributes.get('strides', [1, 1])]
    x = torch.nn.functional.pad(x, (p[1], p[3], p[0], p[2]))
    oc, ic, kh, kw = w.shape
    cols = x.unfold(2, kh, s[0]).unfold(3, kw, s[1])
    n, _, ho, wo = cols.shape[:4]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(n, ho, wo, ic * kh * kw)
    return (cols @ w.reshape(oc, -1).T).permute(0, 3, 1, 2)


def _device_profile(call):
    """One call under torch.profiler: (wall ms, device busy ms, device
    events, the 8 kernels of most device time as (ms, calls, name)), or
    None where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        return None
    top = [(t / 1e3, c, k[:80]) for t, c, k in sorted(rows)[::-1][:8]]
    return (wall, sum(t for t, _, _ in rows) / 1e3,
            sum(c for _, c, _ in rows), top)


def _runner_metrics(tag, run, xs, batch=None, out_shape=None, path='H'):
    """Capture (the first call), then SIM_REPEATS chains on the host clock,
    one chain under the profiler, peak memory since the runner was made.
    `batch` images (sequences) a forward, `out_shape` one forward's output
    (path H's by default)."""
    batch = SIM_BATCH if batch is None else batch
    out_shape = (SIM_BATCH, 1000) if out_shape is None else tuple(out_shape)
    chain = xs.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(xs)[0]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(SIM_REPEATS):
        out = run(xs)[0]
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t0) / SIM_REPEATS * 1e3
    prof = _device_profile(lambda: run(xs))
    m = dict(capture_s=capture_s, ms_per_chain=chain_ms,
             img_per_s=batch * chain / chain_ms * 1e3,
             launches_per_replay=dict(run.launches_per_replay),
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if prof is None:
        m.update(busy_share='not measured', device_events_per_replay=
                 'not measured')
    else:
        wall, busy, events, top = prof
        m.update(profiled_wall_ms=wall, device_busy_ms=busy,
                 busy_share=busy / wall, device_events_per_replay=events,
                 top_kernels_ms_calls=top)
    if tuple(out.shape) != (chain,) + out_shape or \
            not torch.isfinite(out).all():
        raise AssertionError(f'{tag} runner: shape {tuple(out.shape)}, '
                             f'finite {bool(torch.isfinite(out).all())}')
    log(f'[path {path}] runner {tag}: {json.dumps(m)}')
    return m, out


def _activation_scales(graph):
    """Scale of every calibrated activation root TQC, by site."""
    out = {}
    for name, op in graph.operations.items():
        if not hasattr(op, 'config'):
            continue
        for idx, (var, cfg) in enumerate(op.config_pairs()):
            if not var.is_parameter and cfg.is_root and \
                    cfg.state.name == 'ACTIVATED':
                out[(name, idx)] = np.asarray(cfg.scale, np.float64)
    return out


def _scale_spread(a, b):
    sa, sb = _activation_scales(a), _activation_scales(b)
    if sorted(sa) != sorted(sb) or len(sa) != 41:
        raise AssertionError(f'calibrated sites differ: {len(sa)}, {len(sb)}')
    return max(float(np.max(np.abs(sa[k] - sb[k]) / sb[k])) for k in sa)


def _observer_graphs(dev):
    """Path A's two observer calibrations alone (percentile over
    CALIB_STEPS batches, KL over KL_STEPS), for `--compiled`."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.zoo import resnet18
    shape, loader, _ = _data()
    graphs = []
    for algo, steps in (('percentile', CALIB_STEPS), ('kl', KL_STEPS)):
        setting = QuantizationSettingFactory.default_setting()
        if algo == 'kl':
            setting.quantize_activation_setting.calib_algorithm = 'kl'
        graph = resnet18(input_shape=shape)
        with _observer_path():
            quantize_graph(graph, loader[:steps], calib_steps=steps,
                           platform=TargetPlatform.TPU_INT8, setting=setting,
                           verbose=False)
        graphs.append(graph)
    return graphs


def _quantile_kinds(dev, loader):
    """The 'percentile' kind (top-k, the port's choice on every device)
    against 'quantile_bisect' (the JAX package's on the TPU), each a
    captured calibration walk over all 41 sites at batch 32: ms a replay
    (CUDA events, median of 10) and how far the bisection's thresholds lie
    from the quantiles."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.quantization.optim.fcalibration import \
        _activation_roots
    from ppq_tpu_torch.zoo import resnet18
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation = False
    graph = resnet18(input_shape=list(loader[0].shape))
    # without activation scales the bias scales stay underived, which the
    # package reports per conv; nothing here reads them. (The logger is
    # made first: it sets its level once, when it is made.)
    from ppq_tpu_torch.core import PPQLogger
    logger = PPQLogger()
    level = logging.getLogger('ppq_tpu_torch').level
    logger.set_level(logging.ERROR)
    try:
        quantize_graph(graph, loader[:1], calib_steps=1, setting=setting,
                       platform=TargetPlatform.TPU_INT8, verbose=False)
    finally:
        logger.set_level(level)
    targets = _activation_roots(graph)
    cg = compile_graph(graph)
    params = cg.init_params()
    x = torch.as_tensor(loader[0], device=dev)
    out = {}
    stats = {}
    for kind in ('percentile', 'quantile_bisect'):
        fn = cg.build_calibration_forward(
            {n: {'kind': kind, 'percentile': 0.9999} for n in targets})
        fn(params, x)
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = fn(params, x)[1]
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        stats[kind] = {n: (float(v[0]), float(v[1])) for n, v in got.items()}
        out[f'{kind}_ms_per_batch'] = statistics.median(times)
        del fn
    # the distance in units of the site's range (a quantile may be 0)
    out['bisect_vs_percentile_max_of_range'] = max(
        max(abs(b - p) for b, p in zip(stats['quantile_bisect'][n],
                                       stats['percentile'][n]))
        / max(max(abs(v) for v in stats['percentile'][n]), 1e-12)
        for n in targets)
    return out


def phase_path_h(dev, pct_observer, kl_observer):
    """The compiled executor and the compiled calibration: quantize_graph's
    default calibration (percentile over CALIB_STEPS batches of 32, KL over
    KL_STEPS), then stem_space_to_depth and bench.py's runners at batch
    SIM_BATCH in chains of SIM_CHAIN ('int', 'highest', 'bf16'), each one
    CUDA graph a chain. Then, outside the counts: calibration against path
    A's observer graphs, exactness of 'int' against int64 sums and against
    the CPU, replays against the uncaptured walk and chain-1 replays, rows
    1-3 inside captured graphs against their plain versions, and 'int'
    against 'highest' and the fp32 model."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.ir.morph import stem_space_to_depth
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization import solvers
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    from ppq_tpu_torch.quantization.optim.fcalibration import \
        LAST_CALIBRATION_PROFILE
    from ppq_tpu_torch.zoo import resnet18
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    if solvers._native() is None:
        raise AssertionError('path H: the native solver library did not build')
    shape, loader, _ = _data()
    torch.cuda.empty_cache()

    # ---------------- the main path (the counts are read at its end)
    reset_launches()
    graph = resnet18(input_shape=shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_graph(graph, loader, calib_steps=CALIB_STEPS,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    cal_pct = _cal_rates(LAST_CALIBRATION_PROFILE)
    cal_pct['quantize_graph_s'] = time.perf_counter() - t0
    kl_graph = resnet18(input_shape=shape)
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation_setting.calib_algorithm = 'kl'
    searches = dict(solvers.SEARCHES)
    t0 = time.perf_counter()
    quantize_graph(kl_graph, loader[:KL_STEPS], calib_steps=KL_STEPS,
                   platform=TargetPlatform.TPU_INT8, setting=setting,
                   verbose=False)
    torch.cuda.synchronize()
    cal_kl = _cal_rates(LAST_CALIBRATION_PROFILE)
    cal_kl['quantize_graph_s'] = time.perf_counter() - t0
    searched = {k: solvers.SEARCHES[k] - searches[k] for k in searches}
    if searched != {'native': 41, 'numpy': 0}:
        raise AssertionError(f'path H: the KL searches were {searched}, not '
                             f'41 in the native library')
    log(f'[path H] calibration percentile {json.dumps(cal_pct)}')
    log(f'[path H] calibration kl {json.dumps(cal_kl)}; searches {searched}')

    sim_graph = graph.copy(copy_value=True)
    if stem_space_to_depth(sim_graph) != 1:
        raise AssertionError('path H: the stem was not rewritten')
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = torch.randn(SIM_CHAIN, SIM_BATCH, 3, IMAGE, IMAGE, device=dev,
                     generator=gen)
    runners, outs, metrics = {}, {}, {}
    # the runners and their checks under cuDNN's timed algorithm choice, a
    # common setting of users: the 'int' contractions pin their own
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False
    for precision in ('int', 'highest', 'bf16'):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cg = compile_graph(sim_graph, precision=precision)
        run = cg.make_runner(chain=SIM_CHAIN)
        metrics[precision], outs[precision] = _runner_metrics(precision, run,
                                                              xs)
        runners[precision] = run
        del run
    launches = dict(LAUNCHES)

    # ---------------- checks: these launches are not the main path's
    spread_pct = _scale_spread(graph, pct_observer)
    spread_kl = _scale_spread(kl_graph, kl_observer)
    if spread_pct > PCT_SUM_BOUND:
        raise AssertionError(f'compiled percentile scales {spread_pct} from '
                             f'path A\'s, above {PCT_SUM_BOUND}')
    for precision in ('highest', 'bf16', 'int'):
        if not torch.equal(runners[precision].walk(xs)[0], outs[precision]):
            raise AssertionError(f'the {precision!r} replay differs from '
                                 f'its uncaptured walk')
        if precision != 'int':
            del runners[precision]
    torch.cuda.empty_cache()
    run = runners.pop('int')
    cg = run.cg
    one = cg.make_runner()
    for i in range(SIM_CHAIN):
        if not torch.equal(one(xs[i])[0], outs['int'][i]):
            raise AssertionError(f'chain element {i} differs from a chain-1 '
                                 f'replay')
    # a runner replays the scales it was captured with: doubled scales
    # written back drop the TQCs' device copies, which its graph still reads
    # while fresh allocations take the freed memory; a new runner reads them
    qparams = cg.init_qparams()
    cg.write_back_qparams({k: {'scale': v['scale'] * 2, 'offset': v['offset']}
                           for k, v in qparams.items()})
    junk = [torch.full((64,), float('nan'), device=dev) for _ in range(4096)]
    stale = torch.equal(one(xs[0])[0], outs['int'][0])
    fresh = torch.equal(cg.make_runner()(xs[0])[0], outs['int'][0])
    cg.write_back_qparams(qparams)
    del one, junk
    if not stale or fresh:
        raise AssertionError(f'after new scales: the old runner replays its '
                             f'own logits {stale}, a new runner too {fresh}')
    # exactness: the stem, the first 3x3 conv under 2^24 and the first one
    # whose worst case passes it, against int64 sums on two images
    convs = [op for op in cg._order if op.type == 'Conv']
    stem = convs[0]
    safe = next(op for op in convs[1:] if op.name not in cg.int_accum_risk
                and np.asarray(op.inputs[1].value).shape[2:] == (3, 3))
    risky = next(op for op in convs if op.name in cg.int_accum_risk)
    taken = {}

    def probe(op, qx, qw, y):
        if op in (stem, safe, risky):
            taken[op.name] = (op, qx[:2].cpu(), qw.cpu(), y[:2].cpu())

    cg.int_probe = probe
    cg._walk(run.params, {'input': xs[0]})
    cg.int_probe = None
    for name, (op, qx, qw, y) in taken.items():
        gold = _int64_conv(qx, qw, op)
        if not torch.equal(y.to(torch.float64), gold.to(torch.float64)):
            raise AssertionError(f'{name}: the card\'s integer sums differ '
                                 f'from int64')
    if len(taken) != 3:
        raise AssertionError(f'exactness: probed {sorted(taken)}')
    cpu_cg = compile_graph(sim_graph, precision='int', device='cpu')
    cpu_out = cpu_cg.make_runner()(xs[0][:SIM_CPU_IMAGES].cpu())[0]
    if not torch.equal(cpu_out, outs['int'][0][:SIM_CPU_IMAGES].cpu()):
        raise AssertionError("the card's 'int' logits differ from the CPU's")
    if cpu_cg.int_accum_risk != cg.int_accum_risk or \
            cpu_cg.int_lowered != cg.int_lowered:
        raise AssertionError('the CPU lowered other ops')
    del run, cpu_cg
    torch.cuda.empty_cache()
    # rows 1-3 inside captured graphs against their plain versions: an
    # 'int' runner at batch 32 and a one-batch KL calibration
    with _GraphShadow() as shadow:
        shadow_run = compile_graph(sim_graph, precision='int').make_runner()
        shadow_run(xs[0][:CALIB_BATCH])
        held = shadow.check("'int' runner")
        shadow_kl = resnet18(input_shape=shape)
        quantize_graph(shadow_kl, loader[:1], calib_steps=1,
                       platform=TargetPlatform.TPU_INT8, setting=setting,
                       verbose=False)
        for k, v in shadow.check('KL calibration').items():
            held[k] = held.get(k, 0) + v
    del shadow_run
    if any(held.get(k, 0) <= 0 for k in
           ('fake_quant_tensorwise', 'fake_quant_channelwise', 'histogram')):
        raise AssertionError(f'rows 1-3 not all held inside a capture: {held}')
    # against 'highest' and the fp32 model
    snr_highest = float(torch_snr_error(outs['int'][0], outs['highest'][0]))
    fp32 = TorchExecutor(resnet18(input_shape=[SIM_BATCH, 3, IMAGE, IMAGE]))
    y_fp32 = fp32.forward(xs[0])[0]
    snr_fp32 = float(torch_snr_error(outs['int'][0], y_fp32))
    snr_bf16 = float(torch_snr_error(outs['bf16'][0], outs['highest'][0]))
    if not (snr_highest < SNR_INT8_BOUND and snr_fp32 < SNR_INT8_BOUND):
        raise AssertionError(f"'int' SNR too large: {snr_highest} against "
                             f"'highest', {snr_fp32} against fp32")
    del fp32, y_fp32
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    summary = dict(
        calibration_percentile=cal_pct, calibration_kl=cal_kl,
        runners=metrics,
        percentile_scales_max_rel_vs_path_a=spread_pct,
        percentile_bound=PCT_SUM_BOUND,
        kl_scales_max_rel_vs_path_a=spread_kl,
        int_lowered=len(cg.int_lowered), int_coded=len(cg.int_coded),
        int_accum_risk=cg.int_accum_risk,
        exact_convs=sorted(taken), card_equals_cpu_images=SIM_CPU_IMAGES,
        replay_equals_walk=True, chain_equals_chain1=True,
        old_runner_keeps_its_scales=True,
        rows_held_inside_captures=held,
        snr_int_vs_highest=snr_highest,
        top1_int_vs_highest=float((outs['int'][0].argmax(-1) ==
                                   outs['highest'][0].argmax(-1))
                                  .float().mean()),
        snr_int_vs_fp32=snr_fp32, snr_bf16_vs_highest=snr_bf16,
        quantile_kinds=_quantile_kinds(dev, loader))
    log(f'[path H] {json.dumps(summary)}')
    return launches, summary


def main_compiled() -> int:
    """Path H alone (with path A's two observer calibrations to hold it
    against): the quick loop for the compiled executor."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['fake_quant', 'histogram'])
    pct_observer, kl_observer = _observer_graphs(dev)
    launches, _ = phase_path_h(dev, pct_observer, kl_observer)
    log(f'[launches] path H {json.dumps(launches)}')
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ path I
# ingest and export. The deployed QDQ graph against the simulation under the
# JAX package's exporter bounds (tests/test_exporters.py:44-47: SNR;
# tests/test_qdq_hygiene.py:72-75: max |diff| over max |simulated|)
QDQ_SNR_BOUND, QDQ_REL_BOUND = 1e-3, 5e-2
# load_torch_model: the module and its parsed graph in float32 with TF32
# off. The exporter folds each BatchNormalization into its convolution, so
# the two sum in another order and round the folded weights once more:
# held within this share of the largest |logit| (the CPU measured 2.4e-7
# at 2 x 3 x 224 x 224)
TORCH_IMPORT_TOL = 1e-5
# QuantizeLinear's kernel against its plain twin: this many of the deployed
# graph's activation sites, taken from one eager forward
QDQ_HELD_SITES = 8
# the deployed TPU_INT8 ResNet-18's QuantizeLinears, each an activation's
DEPLOYED_Q_SITES = 49


def _resnet18_module(seed=0):
    """A ResNet-18-shaped torch.nn.Module (BasicBlocks [2, 2, 2, 2], widths
    64-512, 1000 classes; torchvision's layout, written out here) with
    seeded weights and BatchNorm statistics, in eval mode on the host."""
    import torch.nn as nn

    class Block(nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(cout)
            self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(cout)
            self.down = None
            if stride != 1 or cin != cout:
                self.down = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            y = torch.relu(self.bn1(self.conv1(x)))
            y = self.bn2(self.conv2(y))
            return torch.relu(y + (x if self.down is None else self.down(x)))

    class ResNet18(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
                nn.ReLU(), nn.MaxPool2d(3, 2, 1))
            blocks, cin = [], 64
            for cout, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
                blocks += [Block(cin, cout, stride), Block(cout, cout, 1)]
                cin = cout
            self.blocks = nn.Sequential(*blocks)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(512, 1000)

        def forward(self, x):
            x = self.pool(self.blocks(self.stem(x)))
            return self.fc(torch.flatten(x, 1))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ResNet18()
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.weight.data.uniform_(0.5, 1.5)
                m.bias.data.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    return model.eval()


def _same_parameters(a, b) -> int:
    """Raise unless graphs a and b hold the same parameter variables, bit
    for bit; return their count."""
    pa = {k: v for k, v in a.variables.items() if v.is_parameter and v.has_value}
    pb = {k: v for k, v in b.variables.items() if v.is_parameter and v.has_value}
    if set(pa) != set(pb):
        raise AssertionError(f'parameters differ by name: '
                             f'{sorted(set(pa) ^ set(pb))[:8]}')
    for k in pa:
        x, y = np.asarray(pa[k].value), np.asarray(pb[k].value)
        if x.dtype != y.dtype or x.shape != y.shape or \
                x.tobytes() != y.tobytes():
            raise AssertionError(f'parameter {k} differs after the round trip')
    return len(pa)


def _same_qparams(a, b) -> int:
    """Raise unless every TQC of graph a has its counterpart in b (the op of
    the same name, the same position) with the same state, scale and offset,
    bit for bit; return the number compared with a scale."""
    from ppq_tpu_torch.ir import QuantableOperation
    n = 0
    for name, op in a.operations.items():
        if not isinstance(op, QuantableOperation):
            continue
        other = b.operations.get(name)
        if not isinstance(other, QuantableOperation):
            raise AssertionError(f'{name} is not quantized in both graphs')
        for ca, cb in zip(op.config, other.config):
            if ca.state != cb.state or ca.has_scale != cb.has_scale:
                raise AssertionError(f'{name}: TQC state {ca.state} / '
                                     f'{cb.state}')
            if ca.has_scale:
                for fa, fb in ((ca.scale, cb.scale), (ca.offset, cb.offset)):
                    if np.asarray(fa, np.float32).tobytes() != \
                            np.asarray(fb, np.float32).tobytes():
                        raise AssertionError(f'{name}: scale or offset differ')
                n += 1
    return n


def _deployed_vs_sim(dep, sim):
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    snr = float(torch_snr_error(dep, sim))
    rel = float((dep - sim).abs().max() / (sim.abs().max() + 1e-9))
    top1 = float((dep.argmax(-1) == sim.argmax(-1)).float().mean())
    return dict(snr=snr, max_rel_err=rel, top1_agree=top1)


class _QuantizeLinearInputs:
    """RuntimeHooks that keep the inputs of the deployed graph's first
    `n` QuantizeLinear ops of one forward."""

    def __init__(self, graph, n):
        from ppq_tpu_torch.executor import RuntimeHook
        self.taken = []
        taken = self.taken

        class Take(RuntimeHook):
            def pre_forward_hook(self, inputs, **kwargs):
                taken.append((self._hook_to, list(inputs)))
                return inputs

        ops = [op for op in graph.topological_sort()
               if op.type == 'QuantizeLinear'][:n]
        self.hooks = {op.name: Take(op) for op in ops}


def phase_path_i(dev):
    """Ingest and export at the zoo ResNet-18's full width: the seeded graph
    written to ONNX and parsed back, `quantize_onnx_model` on the file
    (TPU_INT8, percentile over path H's batches, the compiled calibration)
    and its 'int' runner at batch SIM_BATCH, `export_ppq_graph` to
    TPU_INT8 QDQ, TRT_INT8 QDQ and TensorRT's JSON ranges, NCNN_INT8's
    table and a native checkpoint, the QDQ file parsed and run on the card
    (eager at batch 32, a 'highest' runner at SIM_BATCH), the checkpoint
    loaded and run, and a torch.nn.Module through `load_torch_model`. Then,
    outside the counts: the parameters after the round trip, the TQCs and
    'int' logits against `quantize_graph` on the zoo graph, the deployed
    graph against the simulation, the native graph's logits, QuantizeLinear's
    kernel against its plain twin (activations of the deployed graph, and
    every conv and Gemm weight against the int8 initializer the exporter wrote), and the
    torch module against its parsed graph."""
    import tempfile
    from ppq_tpu_torch import (TargetPlatform, TorchExecutor,
                               export_ppq_graph, load_native_graph,
                               load_onnx_graph, quantize_graph,
                               quantize_onnx_model)
    from ppq_tpu_torch.api import load_torch_model
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.executor.ops.default import (quantize_linear,
                                                    quantize_linear_plain,
                                                    simulation_precision)
    from ppq_tpu_torch.frontends.native import NativeExporter
    from ppq_tpu_torch.frontends.onnx import OnnxExporter
    from ppq_tpu_torch.frontends.tensorrt import TensorRTExporter_JSON
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.zoo import resnet18
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    shape, loader, x_eval = _data()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)
    xs = torch.randn(SIM_BATCH, 3, IMAGE, IMAGE, device=dev, generator=gen)
    x32 = torch.as_tensor(x_eval, device=dev)
    seconds, sizes = {}, {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        files = {k: os.path.join(tmp, v) for k, v in dict(
            fp32='resnet18.onnx', qdq='resnet18_qdq.onnx',
            qdq_json='resnet18_qdq.json', trt='resnet18_trt.onnx',
            trt_json='resnet18_trt.json', trt_ranges='resnet18_trt_fp32.onnx',
            trt_ranges_json='resnet18_trt_ranges.json',
            ncnn='resnet18_ncnn.onnx', ncnn_table='resnet18_ncnn.table',
            native='resnet18.native').items()}

        # ---------------- the main path (the counts are read at its end)
        reset_launches()
        zoo = resnet18(input_shape=shape)
        timed('write_onnx', lambda: OnnxExporter().export(files['fp32'], zoo))
        parsed = timed('parse_onnx', lambda: load_onnx_graph(files['fp32']))
        quantized = timed('quantize_onnx_model', lambda: quantize_onnx_model(
            files['fp32'], loader, calib_steps=CALIB_STEPS,
            platform=TargetPlatform.TPU_INT8, verbose=False))
        run_int = compile_graph(quantized, precision='int').make_runner()
        logits_int = timed('int_runner_capture', lambda: run_int(xs)[0])
        del run_int
        timed('export_tpu_int8_qdq', lambda: export_ppq_graph(
            quantized, TargetPlatform.TPU_INT8, files['qdq'],
            files['qdq_json']))
        timed('export_trt_int8_qdq', lambda: export_ppq_graph(
            quantized, TargetPlatform.TRT_INT8, files['trt'],
            files['trt_json']))
        timed('export_trt_json', lambda: TensorRTExporter_JSON().export(
            files['trt_ranges'], quantized,
            config_path=files['trt_ranges_json']))
        timed('export_ncnn_int8', lambda: export_ppq_graph(
            quantized, TargetPlatform.NCNN_INT8, files['ncnn'],
            files['ncnn_table']))
        timed('export_native', lambda: NativeExporter().export(
            files['native'], quantized))
        for k, path in files.items():
            sizes[k] = os.path.getsize(path)
        deployed = timed('parse_qdq', lambda: load_onnx_graph(files['qdq']))
        before = dict(LAUNCHES)
        dep32 = timed('deployed_eager_b32', lambda: TorchExecutor(
            deployed).forward(x32)[0])
        run_dep = compile_graph(deployed, precision='highest').make_runner()
        dep256 = timed('deployed_runner_capture', lambda: run_dep(xs)[0])
        t0 = time.perf_counter()
        for _ in range(SIM_REPEATS):
            dep256 = run_dep(xs)[0]
        torch.cuda.synchronize()
        dep_img_s = SIM_BATCH * SIM_REPEATS / (time.perf_counter() - t0)
        dep_launches = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES
                        if LAUNCHES[k] != before.get(k, 0)}
        dep_per_replay = dict(run_dep.launches_per_replay)
        del run_dep
        reloaded = timed('load_native', lambda: load_native_graph(
            files['native']))
        run_native = compile_graph(reloaded, precision='int').make_runner()
        logits_native = timed('native_int_runner_capture',
                              lambda: run_native(xs)[0])
        del run_native
        module = _resnet18_module()
        imported = timed('load_torch_model', lambda: load_torch_model(
            module, torch.zeros(1, 3, IMAGE, IMAGE)))
        y_imported = timed('imported_eager_b32', lambda: TorchExecutor(
            imported).forward(x32)[0])
        launches = dict(LAUNCHES)

        # ---------------- checks: these launches are not the main path's
        n_params = _same_parameters(zoo, parsed)
        reference = resnet18(input_shape=shape)
        quantize_graph(reference, loader, calib_steps=CALIB_STEPS,
                       platform=TargetPlatform.TPU_INT8, verbose=False)
        n_tqcs = _same_qparams(reference, quantized)
        run_ref = compile_graph(reference, precision='int').make_runner()
        if not torch.equal(run_ref(xs)[0], logits_int):
            raise AssertionError("path I: quantize_onnx_model's 'int' logits "
                                 "differ from quantize_graph's on the zoo "
                                 "graph")
        del run_ref
        if not torch.equal(logits_native, logits_int):
            raise AssertionError("path I: the native checkpoint's 'int' "
                                 "logits differ")
        sim32 = TorchExecutor(quantized).forward(x32)[0]
        run_sim = compile_graph(quantized, precision='highest').make_runner()
        sim256 = run_sim(xs)[0]
        del run_sim
        held = dict(b32=_deployed_vs_sim(dep32, sim32),
                    b256=_deployed_vs_sim(dep256, sim256))
        for key, m in held.items():
            if not (m['snr'] < QDQ_SNR_BOUND and
                    m['max_rel_err'] < QDQ_REL_BOUND):
                raise AssertionError(f'path I: deployed graph vs simulation '
                                     f'at {key}: {m}')
        for key, out in (('b32', dep32), ('b256', dep256)):
            if out.shape[-1] != 1000 or not torch.isfinite(out).all():
                raise AssertionError(f'path I: deployed output at {key}')
        # TPU_INT8 ships the weights as int8 initializers: every
        # QuantizeLinear is an activation's, per-tensor (row 1), once in the
        # eager forward, at the runner's walk and at its capture
        q_sites = sum(op.type == 'QuantizeLinear'
                      for op in deployed.operations.values())
        if q_sites != DEPLOYED_Q_SITES or \
                dep_per_replay != {'fake_quant_tensorwise': q_sites} or \
                dep_launches != {'fake_quant_tensorwise': 3 * q_sites}:
            raise AssertionError(f'path I: the deployed graph has {q_sites} '
                                 f'QuantizeLinears and launched '
                                 f'{dep_launches} ({dep_per_replay} a '
                                 f'replay), not {DEPLOYED_Q_SITES} of row 1')
        # QuantizeLinear: kernel against twin on the deployed graph's own
        # activation inputs, then every weight quantized on the card against
        # its int8 initializer (written by the exporter on the host)
        take = _QuantizeLinearInputs(deployed, QDQ_HELD_SITES)
        TorchExecutor(deployed).forward(x32, hooks=take.hooks)
        sites = 0
        for op, (x, scale, zp) in take.taken:
            zp_t = torch.as_tensor(np.asarray(zp, np.float32), device=dev)
            dtype = torch.from_numpy(np.asarray(zp)).dtype
            got = quantize_linear(x, scale, zp_t, None, dtype)
            want = quantize_linear_plain(x, scale, zp_t, None, dtype)
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError(f'path I: QuantizeLinear {op.name}: '
                                     f'kernel != twin')
            sites += 1
        weights = 0
        for op in deployed.operations.values():
            w = op.inputs[0]
            if op.type != 'DequantizeLinear' or not w.is_parameter or \
                    np.asarray(w.value).ndim < 2:
                continue
            src = quantized.variables[w.name]
            owner = src.dest_ops[0]
            fp32 = getattr(owner, '_fp32_params', {}).get(w.name, src.value)
            x = torch.as_tensor(np.asarray(fp32, np.float32), device=dev)
            scale = torch.as_tensor(np.asarray(op.inputs[1].value),
                                    device=dev)
            zp = np.asarray(op.inputs[2].value)
            zp_t = torch.as_tensor(zp.astype(np.float32), device=dev)
            axis = int(op.attributes.get('axis', 1))
            dtype = torch.from_numpy(zp).dtype
            got = quantize_linear(x, scale, zp_t, axis, dtype)
            want = quantize_linear_plain(x, scale, zp_t, axis, dtype)
            init = torch.as_tensor(np.asarray(w.value), device=dev)
            if not (torch.equal(got, want) and torch.equal(got, init)):
                raise AssertionError(f'path I: per-axis QuantizeLinear of '
                                     f'{w.name} != twin or initializer')
            weights += 1
        if sites != QDQ_HELD_SITES or weights != 21:
            raise AssertionError(f'path I: held {sites} activation sites and '
                                 f'{weights} weights')
        with torch.no_grad(), simulation_precision('highest'):
            y_module = module.to(dev)(x32)
        torch.cuda.synchronize()
        imported_err = float((y_imported - y_module).abs().max() /
                             y_module.abs().max())
        if not imported_err < TORCH_IMPORT_TOL:
            raise AssertionError(f'path I: load_torch_model forward off by '
                                 f'{imported_err} of the largest logit')
    summary = dict(
        seconds=seconds, bytes=sizes, parameters_bit_equal=n_params,
        tqcs_bit_equal=n_tqcs, int_logits_equal_zoo=True,
        native_int_logits_equal=True,
        deployed_vs_simulation=held, deployed_runner_img_per_s=dep_img_s,
        deployed_launches=dep_launches,
        deployed_launches_per_replay=dep_per_replay,
        quantize_linear_held=dict(activation_sites=sites, weights=weights),
        torch_import_max_err_share=imported_err,
        torch_import_bound=TORCH_IMPORT_TOL,
        deployed_ops=sorted({op.type for op in deployed.operations.values()}))
    log(f'[path I] {json.dumps(summary)}')
    return launches, summary


def main_frontends() -> int:
    """Path I alone: the quick loop for ingest and export."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['fake_quant', 'histogram'])
    launches, _ = phase_path_i(dev)
    log(f'[launches] path I {json.dumps(launches)}')
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ path J
# the whole op library, and the zoo beyond ResNet: BERT-base at its
# published widths (Devlin et al., 2019: L = 12, H = 768, A = 12, FFN 4H)
# over pre-embedded N(0, 1) inputs of 128 tokens, in batches of 32
BERT_BASE = dict(seq_len=128, d_model=768, n_heads=12, n_layers=12,
                 d_ff=3072)
BERT_BATCH, BERT_CHAIN, BERT_FP8_STEPS = 32, 4, 4
# the JAX zoo test's bounds on the SNR against fp32
# (tests/test_zoo_models.py:32-35 INT8, :38-52 FP8)
BERT_SNR_INT8, BERT_SNR_FP8 = 0.1, 0.05
# the card's 'int' against the CPU's on 2 sequences: between the integer
# contractions, LayerNormalization, Softmax and Gelu run the two devices'
# float32 libraries, whose last bits differ, so a code may flip at a grid
# tie and travel: tests/test_torch_slice.py's bar for such a cascade
BERT_INT_CARD_VS_CPU_SNR, BERT_CPU_SEQUENCES = 5e-3, 2
# the other twelve zoo graphs at their builders' default sizes, each held
# against fp32 within the SNR bound tests/test_zoo_models.py sets for it
# (mobilenet_v2: the bound of its equalized run; it runs here with the
# default setting, and path K runs it equalized, with KL and
# BiasCorrection, at batch 32); ResNet-18 within path A's bound and
# tiny_cnn within the vision graphs' 0.1, which that file does not test
ZOO_GRAPHS = {
    'resnet18': SNR_INT8_BOUND, 'tiny_cnn': 0.1, 'mobilenet_v2': 0.6,
    'se_resnet_lite': 0.1, 'resnext_lite': 0.1, 'shufflenet_v2_lite': 0.1,
    'mha_fused_encoder': 0.1, 'crnn_ocr': 0.1, 'yolo_lite': 0.05,
    'deeplab_lite': 0.05, 'srcnn': 0.05, 'unet_lite': 0.05,
}
ZOO_STEPS = 4
# the op library's kernel rows on path J, by LAUNCHES key
PATH_J_ROWS = {'1': 'fake_quant_tensorwise', '2': 'fake_quant_channelwise',
               '3': 'histogram', '6t': 'floating_quant'}
# row 1's launches in one BERT-base INT8 forward and row 6t's in one FP8
# forward: one a quantization site that quantize_graph leaves active.
# INT8: 32 a layer (the outputs of 8 MatMuls, 8 Adds, 4 Reshapes, 5
# Transposes, the scale Mul, Softmax, Gelu and 2 LayerNormalizations, and 2
# inputs) and 4 more in the first, where K, V and the residual Add read the
# embeddings and the Add's other input then joins its grid (the compiled
# calibration calibrates every reader of a shared input: ROADMAP.md queue
# 3, recorded difference 39); FP8 quantizes MatMul and LayerNormalization
# alone: 18 a layer (8 MatMul outputs and 6 inputs, 2 LayerNormalization
# inputs and 2 outputs) and 3 more inputs in the first, where Q, K and V
# read the embeddings. tests/test_torch_zoo.py counts the same on small
# BERT on the CPU. A replay of a runner holds a chain of BERT_CHAIN INT8
# forwards.
BERT_INT8_SITES = 32 * BERT_BASE['n_layers'] + 4
BERT_FP8_SITES = 18 * BERT_BASE['n_layers'] + 3


def _op_cases():
    """tests/torch_op_cases.py of this checkout (it imports nothing of
    JAX)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, 'tests'))
    import torch_op_cases
    return torch_op_cases


def phase_op_sweep(dev):
    """Every case of tests/torch_op_cases.py (every op type of the table and
    the NXP Resize) on the card against the same op on the CPU, within the
    case's card tolerance (equal where the arithmetic is the same
    elementwise order). The largest difference of each case goes to
    chiprun_out/op_sweep.json; the worst by op type to the log."""
    from ppq_tpu_torch.executor import DEFAULT_BACKEND_TABLE
    cases = _op_cases()
    missing = sorted(set(DEFAULT_BACKEND_TABLE)
                     - {c.op_type for c in cases.CASES})
    if missing:
        raise AssertionError(f'op sweep: no case for {missing}')
    t0 = time.perf_counter()
    failed, rows = [], []
    for case in cases.CASES:
        bound = ('equal' if case.card == cases.EXACT else
                 f'rtol {case.card[0]:g} atol {case.card[1]:g}')
        try:
            cpu = cases.run_port(case, 'cpu')
            card = cases.run_port(case, dev)
            err = cases.assert_close(card, cpu, case.card, case.id)
        except Exception as exc:       # reported below: the path fails
            failed.append((case.id, f'{type(exc).__name__}: {exc}'[:400]))
            continue
        rows.append(dict(case=case.id, op=case.op_type,
                         platform=case.platform, max_abs_diff=err,
                         bound=bound))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'op_sweep.json'), 'w') as f:
        json.dump(dict(rows=rows, failed=failed), f, indent=1)
    if failed:
        raise AssertionError(f'op sweep: {len(failed)} of '
                             f'{len(cases.CASES)} cases failed on the card: '
                             f'{failed}')
    worst = {}
    for r in rows:
        key = r['op'] + (f'@{r["platform"]}' if r['platform'] else '')
        worst[key] = max(worst.get(key, 0.0), r['max_abs_diff'])
    summary = dict(cases=len(rows), op_types=len(worst),
                   cases_equal=sum(r['max_abs_diff'] == 0 for r in rows),
                   cases_held_equal=sum(r['bound'] == 'equal' for r in rows),
                   seconds=seconds)
    log(f'[path J] op sweep {json.dumps(summary)}')
    log(f'[path J] op sweep worst |card - cpu| by op: '
        f'{json.dumps({k: float(f"{v:.3g}") for k, v in worst.items() if v})}')
    return summary


def _cal_rates(prof):
    """A compiled calibration's profile with its images (sequences) a
    second, cold (capture included) and warm."""
    sweep = prof['run_s'] + prof.get('run2_s', 0) + prof.get('search_s', 0)
    return dict(prof, cold_img_per_s=prof['images'] / (prof['compile_s']
                                                       + sweep),
                warm_img_per_s=prof['images'] / sweep)


def _bert_batches(dev, n, seed, batch=BERT_BATCH):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, BERT_BASE['seq_len'], BERT_BASE['d_model'])
    return [torch.randn(*shape, device=dev, generator=gen) for _ in range(n)]


def _snr_and_top1(y, ref):
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    snr = float(torch_snr_error(y.reshape(1, -1).float(),
                                ref.reshape(1, -1).float()))
    top1 = float((y.argmax(-1) == ref.argmax(-1)).float().mean())
    return snr, top1


def _zoo_graphs(dev, stats):
    """The other twelve zoo graphs: TPU_INT8 with percentile calibration
    over ZOO_STEPS seeded batches, the eager forward, and where the graph
    compiles a 'highest' runner. Returns {name: (graph, x, eager, runner
    output or None)}."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.executor import compilable, compile_graph
    out = {}
    for k, name in enumerate(ZOO_GRAPHS):
        graph = getattr(zoo, name)()
        shape = list(next(iter(graph.inputs.values())).shape)
        rng = np.random.RandomState(100 + k)
        loader = [rng.randn(*shape).astype(np.float32)
                  for _ in range(ZOO_STEPS + 1)]
        t0 = time.perf_counter()
        quantize_graph(graph, loader[:ZOO_STEPS], calib_steps=ZOO_STEPS,
                       platform=TargetPlatform.TPU_INT8, verbose=False)
        x = torch.as_tensor(loader[-1], device=dev)
        y = TorchExecutor(graph).forward(x)[0]
        ok, _ = compilable(graph)
        y_run = compile_graph(graph).make_runner()(x)[0] if ok else None
        torch.cuda.synchronize()
        stats[name] = dict(shape=shape, seconds=time.perf_counter() - t0,
                           compilable=ok)
        out[name] = (graph, x, y, y_run)
    return out


def phase_path_j(dev):
    """Path J: the op sweep (outside the counts), then the main path:
    BERT-base at full width through quantize_graph with TPU_INT8
    (percentile over CALIB_STEPS batches of 32 through the compiled
    calibration; KL over KL_STEPS), its eager forward at batch 32 and the
    'int', 'highest' and 'bf16' runners in chains of BERT_CHAIN; TPU_FP8
    with fp8_setting (E4M3, the only format the setting offers) and its
    eager forward; the other twelve zoo graphs. Then, outside the counts:
    SNRs and argmax agreement against fp32, the 'int' sums against int64
    on the CPU for a MatMul under 2^24 and an FFN-down MatMul over it, the
    card's 'int' against the CPU's, replays against the uncaptured walk,
    'highest' runners against the eager forward."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization import solvers
    from ppq_tpu_torch.quantization.optim.fcalibration import \
        LAST_CALIBRATION_PROFILE
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_path = time.perf_counter()
    sweep = phase_op_sweep(dev)
    torch.cuda.empty_cache()
    loader = _bert_batches(dev, CALIB_STEPS, seed=0)
    x_eval = _bert_batches(dev, 1, seed=1)[0]
    xs = torch.stack(_bert_batches(dev, BERT_CHAIN, seed=2))
    t0 = time.perf_counter()
    base = zoo.bert_encoder(batch=BERT_BATCH, **BERT_BASE)
    build_s = time.perf_counter() - t0
    n_params = sum(int(np.asarray(v.value).size)
                   for v in base.variables.values()
                   if v.is_parameter and v.has_value)
    name_in = next(iter(base.inputs))

    # ---------------- the main path (the counts are read at its end)
    reset_launches()
    graph = base.copy(copy_value=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_graph(graph, loader, calib_steps=CALIB_STEPS,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    cal_pct = _cal_rates(LAST_CALIBRATION_PROFILE)
    cal_pct['quantize_graph_s'] = time.perf_counter() - t0
    kl_graph = base.copy(copy_value=True)
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation_setting.calib_algorithm = 'kl'
    searches = dict(solvers.SEARCHES)
    t0 = time.perf_counter()
    quantize_graph(kl_graph, loader[:KL_STEPS], calib_steps=KL_STEPS,
                   platform=TargetPlatform.TPU_INT8, setting=setting,
                   verbose=False)
    torch.cuda.synchronize()
    cal_kl = _cal_rates(LAST_CALIBRATION_PROFILE)
    cal_kl['quantize_graph_s'] = time.perf_counter() - t0
    searched = {k: solvers.SEARCHES[k] - searches[k] for k in searches}
    log(f'[path J] BERT-base INT8 calibration percentile '
        f'{json.dumps(cal_pct)}')
    log(f'[path J] BERT-base INT8 calibration kl {json.dumps(cal_kl)}; '
        f'searches {searched}')
    executor = TorchExecutor(graph)
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_int8 = executor.forward(x_eval)[0]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    per_forward_int8 = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                        if LAUNCHES[k] != before[k]}
    y_kl = TorchExecutor(kl_graph).forward(x_eval)[0]
    del executor, kl_graph
    runners, outs, metrics = {}, {}, {}
    for precision in ('int', 'highest', 'bf16'):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = compile_graph(graph, precision=precision).make_runner(
            chain=BERT_CHAIN)
        metrics[precision], outs[precision] = _runner_metrics(
            f'BERT-base {precision}', run, xs, batch=BERT_BATCH,
            out_shape=xs.shape[1:], path='J')
        runners[precision] = run
        del run
    fp8_graph = base.copy(copy_value=True)
    t0 = time.perf_counter()
    quantize_graph(fp8_graph, loader[:BERT_FP8_STEPS],
                   calib_steps=BERT_FP8_STEPS,
                   platform=TargetPlatform.TPU_FP8,
                   setting=QuantizationSettingFactory.fp8_setting(),
                   verbose=False)
    torch.cuda.synchronize()
    fp8_quantize_s = time.perf_counter() - t0
    before = dict(LAUNCHES)
    y_fp8 = TorchExecutor(fp8_graph).forward(x_eval)[0]
    torch.cuda.synchronize()
    per_forward_fp8 = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                       if LAUNCHES[k] != before[k]}
    del fp8_graph, loader
    torch.cuda.empty_cache()
    zoo_stats = {}
    zoo_out = _zoo_graphs(dev, zoo_stats)
    launches = dict(LAUNCHES)
    main_s = time.perf_counter() - t_path - sweep['seconds']

    # ---------------- checks: these launches are not the main path's
    absent = [row for row, k in PATH_J_ROWS.items() if launches.get(k, 0) <= 0]
    if absent:
        raise AssertionError(f'path J: rows {absent} did not launch')
    per_replay = {p: m['launches_per_replay'] for p, m in metrics.items()}
    if per_forward_int8 != {'fake_quant_tensorwise': BERT_INT8_SITES} or \
            per_forward_fp8 != {'floating_quant': BERT_FP8_SITES} or \
            any(v != {'fake_quant_tensorwise': BERT_CHAIN * BERT_INT8_SITES}
                for v in per_replay.values()):
        raise AssertionError(
            f'path J: launches a BERT-base forward: INT8 {per_forward_int8}, '
            f'FP8 {per_forward_fp8}, a replay {per_replay}; expected '
            f'{BERT_INT8_SITES} of row 1, {BERT_FP8_SITES} of row 6t and '
            f'{BERT_CHAIN * BERT_INT8_SITES} of row 1')
    y_fp32 = TorchExecutor(base).forward(x_eval)[0]
    snr_int8, top1_int8 = _snr_and_top1(y_int8, y_fp32)
    snr_kl, top1_kl = _snr_and_top1(y_kl, y_fp32)
    snr_fp8, top1_fp8 = _snr_and_top1(y_fp8, y_fp32)
    if not (snr_int8 < BERT_SNR_INT8 and snr_kl < BERT_SNR_INT8
            and snr_fp8 < BERT_SNR_FP8):
        raise AssertionError(f'path J: BERT-base SNR against fp32: INT8 '
                             f'{snr_int8} (KL {snr_kl}), FP8 {snr_fp8}')
    del y_fp32
    for precision in ('int', 'highest', 'bf16'):
        if not torch.equal(runners[precision].walk(xs)[0], outs[precision]):
            raise AssertionError(f'path J: the BERT-base {precision!r} '
                                 f'replay differs from its uncaptured walk')
        if precision != 'int':
            del runners[precision]
    torch.cuda.empty_cache()
    run = runners.pop('int')
    cg = run.cg
    d_ff = BERT_BASE['d_ff']
    risky = [graph.operations[n] for n in cg.int_accum_risk]
    if len(risky) != BERT_BASE['n_layers'] or any(
            np.asarray(op.inputs[1].value).shape[0] != d_ff for op in risky):
        raise AssertionError(f'path J: int_accum_risk {cg.int_accum_risk} '
                             f'is not the {BERT_BASE["n_layers"]} FFN-down '
                             f'MatMuls')
    safe = next(op for op in cg._order if op.name in cg.int_lowered
                and op.name not in cg.int_accum_risk
                and op.inputs[1].is_parameter)
    probed = {}

    def probe(op, qx, qw, y):
        if op is safe or op is risky[0]:
            probed[op.name] = (qx[0, :8].cpu(), qw.cpu(), y[0, :8].cpu())

    cg.int_probe = probe
    cg._walk(run.params, {name_in: xs[0]})
    cg.int_probe = None
    exact = {}
    for name, (qx, qw, y) in probed.items():
        gold = (qx.to(torch.int64) @ qw.to(torch.int64)).to(torch.float64)
        diff = float((y.to(torch.float64) - gold).abs().max())
        exact[name] = dict(equal=diff == 0, max_abs_diff=diff,
                           over_2_24=name in cg.int_accum_risk)
    if len(exact) != 2 or not exact[safe.name]['equal']:
        raise AssertionError(f'path J: int64 sums {exact}')
    cpu_cg = compile_graph(graph, precision='int', device='cpu')
    cpu_out = cpu_cg.make_runner()(xs[0][:BERT_CPU_SEQUENCES].cpu())[0]
    card_out = outs['int'][0][:BERT_CPU_SEQUENCES].cpu()
    card_vs_cpu = dict(equal=bool(torch.equal(cpu_out, card_out)),
                       max_abs_diff=float((cpu_out - card_out).abs().max()),
                       share_differing=float((cpu_out != card_out)
                                             .float().mean()))
    card_vs_cpu['snr'], card_vs_cpu['top1'] = _snr_and_top1(card_out,
                                                            cpu_out)
    if card_vs_cpu['snr'] > BERT_INT_CARD_VS_CPU_SNR or \
            cpu_cg.int_lowered != cg.int_lowered or \
            cpu_cg.int_accum_risk != cg.int_accum_risk:
        raise AssertionError(f"path J: the card's 'int' against the CPU's "
                             f"{card_vs_cpu}")
    snr_int_vs_highest, top1_int_vs_highest = _snr_and_top1(
        outs['int'][0], outs['highest'][0])
    del run, cpu_cg, outs
    torch.cuda.empty_cache()
    zoo_summary = {}
    for name, (g, x, y, y_run) in zoo_out.items():
        fp32 = TorchExecutor(getattr(zoo, name)()).forward(x)[0]
        snr, top1 = _snr_and_top1(y, fp32)
        if not (torch.isfinite(y).all() and y.shape == fp32.shape and
                snr < ZOO_GRAPHS[name]):
            raise AssertionError(f'path J: {name} SNR {snr} against fp32, '
                                 f'bound {ZOO_GRAPHS[name]}')
        if y_run is not None and not torch.equal(y_run, y):
            raise AssertionError(f"path J: {name}'s 'highest' runner "
                                 f"differs from its eager forward")
        zoo_summary[name] = dict(zoo_stats[name], snr=snr,
                                 bound=ZOO_GRAPHS[name],
                                 runner_equals_eager=y_run is not None)
    del zoo_out
    torch.cuda.empty_cache()
    summary = dict(
        op_sweep=sweep, bert_build_s=build_s, bert_parameters=n_params,
        calibration_percentile=cal_pct, calibration_kl=cal_kl,
        kl_searches=searched, eager_forward_ms=eager_ms,
        eager_seq_per_s=BERT_BATCH / eager_ms * 1e3,
        runners=metrics, fp8_quantize_s=fp8_quantize_s,
        snr_int8_vs_fp32=snr_int8, top1_int8_vs_fp32=top1_int8,
        snr_kl_vs_fp32=snr_kl, top1_kl_vs_fp32=top1_kl,
        snr_fp8_e4m3_vs_fp32=snr_fp8, top1_fp8_e4m3_vs_fp32=top1_fp8,
        snr_int_vs_highest=snr_int_vs_highest,
        top1_int_vs_highest=top1_int_vs_highest,
        int_lowered=len(cg.int_lowered), int_coded=len(cg.int_coded),
        int_accum_risk=cg.int_accum_risk, int64_sums=exact,
        card_int_vs_cpu_int=card_vs_cpu, replay_equals_walk=True,
        launches_per_forward_int8=per_forward_int8,
        launches_per_forward_fp8=per_forward_fp8,
        launches_by_row={row: launches[k] for row, k in PATH_J_ROWS.items()},
        zoo=zoo_summary, main_path_s=main_s,
        path_s=time.perf_counter() - t_path)
    log(f'[path J] {json.dumps(summary)}')
    return launches, summary


def main_ops() -> int:
    """Path J alone: the quick loop for the op library and the zoo."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['fake_quant', 'histogram', 'floating'])
    launches, _ = phase_path_j(dev)
    log(f'[launches] path J {json.dumps(launches)}')
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ path K
# BASELINE.json's MobileNetV2 configuration: the zoo builder at width 1.0,
# 1000 classes, batch 32 at 224x224, TPU_INT8 (per-channel weights), KL over
# PASSES_KL_STEPS batches, LayerwiseEqualization over 10 iterations and
# BiasCorrection; its bound on the SNR against fp32 is the JAX zoo test's
# (tests/test_zoo_models.py:102). The other passes and the analyses run on
# ResNet-18 at the same batch.
PASSES_BATCH, PASSES_KL_STEPS, PASSES_STEPS = 32, 4, 4
EQUALIZATION_ITERATIONS = 10
MOBILENET_SNR_BOUND = 0.6
# a pass that keeps the function keeps the output within this share of its
# largest value, the graph run in float64 before and after the pass (the
# rewritten float32 weights round in their last bits: 3.8e-6 at MobileNetV2's
# full width on the CPU). The float32 forwards of the two graphs differ by
# more, 2.3e-5 there: the float32 forward's own rounding against float64 is
# 2.1e-5 of that model's largest logit, so they are reported, not bounded.
FP32_KEEP_TOL = 1e-5
# the analyses' compiled reports against the eager executor's: the walk and
# the executor run the same kernels on the same values
ANALYSE_STEPS, ANALYSE_RTOL = 2, 1e-6
QUANTZOO_CALIB, QUANTZOO_ERROR = 4, 2
PATH_K_ROWS = {'1': 'fake_quant_tensorwise', '2': 'fake_quant_channelwise',
               '3': 'histogram', '6t': 'floating_quant'}


def _seeded_images(dev, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(PASSES_BATCH, 3, IMAGE, IMAGE, device=dev,
                        generator=gen) for _ in range(n)]


def _float64_output(graph, x):
    """The graph's output with its float32 parameters and input in float64
    (a copy: the graph keeps its values)."""
    from ppq_tpu_torch import TorchExecutor
    wide = graph.copy(copy_value=True)
    for var in wide.variables.values():
        if var.is_parameter and var.has_value and \
                np.asarray(var.value).dtype == np.float32:
            var.value = np.asarray(var.value, np.float64)
    return TorchExecutor(wide).forward(x.double())[0]


def _keeps_function(tag, make_pass, graph, x, loader=None):
    """Run make_pass() on `graph` (formatted fp32) with an executor that
    already ran; hold the float64 output of the graph after the pass
    against the one before, within FP32_KEEP_TOL of its largest value; the
    reused executor against a fresh one bit for bit (the rewritten weights
    reached the card); and every weight the reused executor uploaded
    against the host array bit for bit. Returns the float64 move, the
    float32 move and the float32 forward's own error against float64, each
    over the largest value, and the weights held."""
    from ppq_tpu_torch import TorchExecutor
    executor = TorchExecutor(graph)
    before = executor.forward(x)[0]
    wide_before = _float64_output(graph, x)
    make_pass().optimize(graph, dataloader=loader, executor=executor)
    executor.load_graph(graph)       # as quantize_graph does after a pass
    after = executor.forward(x)[0]
    fresh = TorchExecutor(graph).forward(x)[0]
    if not torch.equal(after, fresh):
        raise AssertionError(f'path K {tag}: the reused executor differs '
                             f'from a fresh one on the rewritten graph')
    held = 0
    for name, (host, on_card) in executor._params.items():
        if isinstance(on_card, torch.Tensor) and on_card.is_floating_point():
            if host is not graph.variables[name].value or not torch.equal(
                    on_card.cpu(), torch.as_tensor(graph.variables[name].value)):
                raise AssertionError(f'path K {tag}: {name} on the card is '
                                     f'not the host value')
            held += 1
    wide_after = _float64_output(graph, x)
    top = float(wide_before.abs().max())
    rel = float((wide_after - wide_before).abs().max()) / top
    if rel > FP32_KEEP_TOL:
        raise AssertionError(f'path K {tag}: the output moved by {rel} of '
                             f'its largest value in float64 (bound '
                             f'{FP32_KEEP_TOL})')
    moved32 = float((after - before).abs().max()) / top
    noise32 = float((before.double() - wide_before).abs().max()) / top
    return dict(float64_moved=rel, float32_moved=moved32,
                float32_vs_float64=noise32, weights_held=held)


def _mobilenet_runs(dev, loader, x, y_fp32):
    """MobileNetV2 through quantize_graph with and without equalization:
    SNR and top-1 against fp32, calibration and KL search seconds."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.quantization.optim.fcalibration import \
        LAST_CALIBRATION_PROFILE
    out = {}
    for equalized in (True, False):
        setting = QuantizationSettingFactory.default_setting()
        setting.quantize_activation_setting.calib_algorithm = 'kl'
        setting.bias_correct = True
        setting.equalization = equalized
        setting.equalization_setting.iterations = EQUALIZATION_ITERATIONS
        graph = zoo.mobilenet_v2(input_shape=[PASSES_BATCH, 3, IMAGE, IMAGE])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quantize_graph(graph, loader, calib_steps=PASSES_KL_STEPS,
                       platform=TargetPlatform.TPU_INT8, setting=setting,
                       verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        y = TorchExecutor(graph).forward(x)[0]
        snr, top1 = _snr_and_top1(y, y_fp32)
        prof = dict(LAST_CALIBRATION_PROFILE)
        out['equalized' if equalized else 'plain'] = dict(
            snr=snr, top1=top1, quantize_graph_s=seconds,
            calibration_s=prof['compile_s'] + prof['run_s']
            + prof.get('run2_s', 0.0) + prof.get('search_s', 0.0),
            kl_search_s=prof.get('search_s'), profile=prof)
        if equalized:
            out['graph'] = graph
    return out


# the prequant passes of the settings' flags at thresholds where they act
# on the seeded models: SSD equalization on MobileNetV2 (its one pass has no
# setting; ResNet-18's weights stay under its 0.5 threshold), the channel
# and weight splits on ResNet-18 (its largest weights 0.16-0.85: the
# defaults, 2 x the median and 2.0, split nothing)
PREQUANT_PASSES = {
    'ssd_equalization': ('mobilenet_v2', None),
    'channel_split': ('resnet18', ('channel_split_setting', 0.9)),
    'weight_split': ('resnet18', ('weight_split_setting', 0.5)),
}


def _prequant_passes(dev, loader, x, references):
    """SSD equalization, channel split and horizontal layer split: each pass
    alone keeps the function (`_keeps_function`) and changes the graph,
    then quantize_graph with its setting flag (percentile, compiled
    calibration): SNR against fp32."""
    from ppq_tpu_torch import (TargetPlatform, TorchExecutor, format_graph,
                               quantize_graph)
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.quantization.optim import (ChannelwiseSplitPass,
                                                  HorizontalLayerSplitPass,
                                                  SSDEqualizationPass)
    shape = [PASSES_BATCH, 3, IMAGE, IMAGE]
    passes = {
        'ssd_equalization': lambda threshold: SSDEqualizationPass(
            calib_steps=PASSES_STEPS),
        'channel_split': lambda threshold: ChannelwiseSplitPass(
            value_threshold=threshold),
        'weight_split': lambda threshold: HorizontalLayerSplitPass(
            value_threshold=threshold),
    }
    out = {}
    for flag, make in passes.items():
        model, sub = PREQUANT_PASSES[flag]
        threshold = sub[1] if sub else None
        graph = format_graph(getattr(zoo, model)(input_shape=shape))
        values = {n: v.value for n, v in graph.variables.items()
                  if v.is_parameter}
        n_ops = len(graph.operations)
        t0 = time.perf_counter()
        kept = _keeps_function(flag, lambda: make(threshold), graph, x,
                               loader)
        pass_s = time.perf_counter() - t0
        rewritten = sum(1 for n, v in graph.variables.items()
                        if v.is_parameter and values.get(n) is not v.value)
        if not rewritten:
            raise AssertionError(f'path K {flag}: the pass changed nothing')
        setting = QuantizationSettingFactory.default_setting()
        setattr(setting, flag, True)
        if sub:
            getattr(setting, sub[0]).value_threshold = sub[1]
        qgraph = getattr(zoo, model)(input_shape=shape)
        t0 = time.perf_counter()
        quantize_graph(qgraph, loader, calib_steps=PASSES_STEPS,
                       platform=TargetPlatform.TPU_INT8, setting=setting,
                       verbose=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        snr, top1 = _snr_and_top1(TorchExecutor(qgraph).forward(x)[0],
                                  references[model])
        bound = MOBILENET_SNR_BOUND if model == 'mobilenet_v2' \
            else SNR_INT8_BOUND
        if not snr < bound:
            raise AssertionError(f'path K {flag}: SNR {snr} against fp32')
        out[flag] = dict(kept, model=model, threshold=threshold,
                         parameters_rewritten=rewritten,
                         ops_added=len(graph.operations) - n_ops,
                         pass_s=pass_s, quantize_graph_s=seconds, snr=snr,
                         top1=top1)
    return out


def _experimental_on_resnet(dev, loader, x, y_fp32, quantized):
    """LearningToCalibPass on a copy of the quantized ResNet-18, and
    MatrixFactorizationPass on its classifier (split to MatMul + Add by
    MetaxGemmSplitPass first: the pass factors plain MatMuls only), each
    with its SNR against fp32 and its seconds."""
    from ppq_tpu_torch import (TargetPlatform, TorchExecutor, format_graph,
                               manop, quantize_graph)
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.quantization.optim import (LearningToCalibPass,
                                                  MatrixFactorizationPass,
                                                  MetaxGemmSplitPass)
    out = {}
    graph = quantized.copy(copy_value=True)
    before, _ = _snr_and_top1(TorchExecutor(graph).forward(x)[0], y_fp32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ltc = LearningToCalibPass(calib_steps=PASSES_STEPS)
    manop(graph, ltc, calib_dataloader=loader, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after, top1 = _snr_and_top1(TorchExecutor(graph).forward(x)[0], y_fp32)
    if not after < SNR_INT8_BOUND:
        raise AssertionError(f'path K learning to calibrate: SNR {after}')
    out['learning_to_calib'] = dict(snr_before=before, snr=after, top1=top1,
                                    seconds=seconds)
    shape = [PASSES_BATCH, 3, IMAGE, IMAGE]
    graph = format_graph(zoo.resnet18(input_shape=shape))
    t0 = time.perf_counter()
    MetaxGemmSplitPass().optimize(graph)
    mf = MatrixFactorizationPass(rank_ratio=0.5)
    mf.optimize(graph)
    pass_s = time.perf_counter() - t0
    factored = [n for n in graph.operations if n.endswith('_svd_1')]
    if not factored:
        raise AssertionError('path K: MatrixFactorizationPass factored '
                             'nothing')
    fp32_snr, _ = _snr_and_top1(TorchExecutor(graph).forward(x)[0], y_fp32)
    t0 = time.perf_counter()
    quantize_graph(graph, loader, calib_steps=PASSES_STEPS,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    snr, top1 = _snr_and_top1(TorchExecutor(graph).forward(x)[0], y_fp32)
    out['matrix_factorization'] = dict(factored=factored, pass_s=pass_s,
                                       fp32_snr=fp32_snr, snr=snr, top1=top1,
                                       quantize_graph_s=seconds)
    return out


def _analyses(dev, graph, loader):
    """graphwise, layerwise, statistical and parameter analyses of the
    quantized ResNet-18 on the compiled executor, with seconds and the peak
    memory of each; the graphwise report held against the eager
    executor's within ANALYSE_RTOL (the layerwise analysis runs the eager
    executor always)."""
    from ppq_tpu_torch.quantization import analyse
    out, reports = {}, {}
    runs = {
        'graphwise': lambda: analyse.graphwise_error_analyse(
            graph, loader, steps=ANALYSE_STEPS, verbose=False),
        'layerwise': lambda: analyse.layerwise_error_analyse(
            graph, loader, steps=ANALYSE_STEPS, verbose=False),
        'statistical': lambda: analyse.statistical_analyse(
            graph, loader, steps=ANALYSE_STEPS),
        'parameter': lambda: analyse.parameter_analyse(graph),
    }
    for name, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        reports[name] = run()
        torch.cuda.synchronize()
        out[name] = dict(seconds=time.perf_counter() - t0, entries=len(
            reports[name]), peak_mib=(torch.cuda.max_memory_allocated()
                                      - base) / 2 ** 20)
    saved = analyse.compilable
    analyse.compilable = lambda g: (False, [])
    try:
        for name in ('graphwise',):
            t0 = time.perf_counter()
            eager = runs[name]()
            torch.cuda.synchronize()
            worst = max(abs(eager[k] - v) / max(abs(v), 1e-30)
                        for k, v in reports[name].items())
            if eager.keys() != reports[name].keys() or \
                    worst > ANALYSE_RTOL:
                raise AssertionError(f'path K {name}: compiled against '
                                     f'eager {worst}')
            out[name].update(eager_seconds=time.perf_counter() - t0,
                             eager_rel_diff=worst)
    finally:
        analyse.compilable = saved
    out['graphwise']['worst'] = max(reports['graphwise'].items(),
                                    key=lambda kv: kv[1])
    out['layerwise']['worst'] = max(reports['layerwise'].items(),
                                    key=lambda kv: kv[1])
    return out


def phase_path_k(dev):
    """Path K: the prequant and manual passes, the analyses and the
    evaluation harnesses at full width. The main path (the counts are read
    at its end): BASELINE.json's MobileNetV2 configuration with and without
    equalization; on ResNet-18 SSD equalization, channel split, horizontal
    layer split, learning to calibrate and matrix factorization; the
    analyses of a quantized ResNet-18; `evaluate_classification` compiled
    and eager; `quantzoo_benchmark` over ResNet-18 and MobileNetV2 x its
    three schemes. Every check raises: the passes that keep the function
    against the fp32 output, the executor's copies of rewritten weights
    against the host, SNR bounds, compiled reports against eager ones."""
    from ppq_tpu_torch import (TargetPlatform, TorchExecutor, format_graph,
                               quantize_graph)
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization.optim import LayerwiseEqualizationPass
    from ppq_tpu_torch.zoo import evaluate
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    shape = [PASSES_BATCH, 3, IMAGE, IMAGE]
    loader = _seeded_images(dev, PASSES_STEPS, seed=40)
    x = _seeded_images(dev, 1, seed=41)[0]
    summary = {}

    reset_launches()
    # MobileNetV2: equalization alone keeps the function, and the card
    # computes with the rewritten weights; the same pass on the CPU gives
    # the same weights
    y_mnv2 = TorchExecutor(zoo.mobilenet_v2(input_shape=shape)).forward(x)[0]
    graph = format_graph(zoo.mobilenet_v2(input_shape=shape))
    kept = _keeps_function(
        'equalization', lambda: LayerwiseEqualizationPass(
            iterations=EQUALIZATION_ITERATIONS), graph, x)
    on_cpu = format_graph(zoo.mobilenet_v2(input_shape=shape))
    LayerwiseEqualizationPass(iterations=EQUALIZATION_ITERATIONS).optimize(
        on_cpu)
    for name, var in on_cpu.variables.items():
        if var.is_parameter and var.has_value and not np.array_equal(
                np.asarray(var.value), np.asarray(graph.variables[name].value)):
            raise AssertionError(f'path K: equalized {name} differs from the '
                                 f'same pass on the CPU')
    del graph, on_cpu
    summary['mobilenet_equalization'] = kept
    runs = _mobilenet_runs(dev, loader, x, y_mnv2)
    mnv2_graph = runs.pop('graph')
    summary['mobilenet_v2'] = runs
    if not runs['equalized']['snr'] < MOBILENET_SNR_BOUND:
        raise AssertionError(f"path K: MobileNetV2 equalized SNR "
                             f"{runs['equalized']['snr']} against fp32, bound "
                             f"{MOBILENET_SNR_BOUND}")
    del mnv2_graph
    torch.cuda.empty_cache()

    y_r18 = TorchExecutor(zoo.resnet18(input_shape=shape)).forward(x)[0]
    summary['prequant_passes'] = _prequant_passes(
        dev, loader, x, {'mobilenet_v2': y_mnv2, 'resnet18': y_r18})
    r18 = zoo.resnet18(input_shape=shape)
    t0 = time.perf_counter()
    quantize_graph(r18, loader, calib_steps=PASSES_STEPS,
                   platform=TargetPlatform.TPU_INT8, verbose=False)
    torch.cuda.synchronize()
    summary['resnet18_quantize_graph_s'] = time.perf_counter() - t0
    summary['resnet18_experimental'] = _experimental_on_resnet(
        dev, loader, x, y_r18, r18)
    summary['analyses'] = _analyses(dev, r18, loader[:ANALYSE_STEPS])
    # labels: the fp32 model's top-1, so top-1 reads the agreement of the
    # quantized model with it
    r18_fp32 = TorchExecutor(zoo.resnet18(input_shape=shape))
    labelled = [(xb, r18_fp32.forward(xb)[0].argmax(-1).cpu().numpy())
                for xb in loader]
    del r18_fp32
    compiled = evaluate.evaluate_classification(r18, labelled)
    eager = evaluate.evaluate_classification(r18, labelled, compiled=False)
    if (compiled['top1'], compiled['top5']) != (eager['top1'], eager['top5']):
        raise AssertionError(f'path K: evaluate_classification compiled '
                             f'{compiled} against eager {eager}')
    summary['evaluate_classification'] = dict(compiled=compiled, eager=eager)
    del r18
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records = evaluate.quantzoo_benchmark(
        {'resnet18': lambda: zoo.resnet18(input_shape=shape),
         'mobilenet_v2': lambda: zoo.mobilenet_v2(input_shape=shape)},
        {'resnet18': loader, 'mobilenet_v2': loader},
        calib_steps=QUANTZOO_CALIB, error_steps=QUANTZOO_ERROR,
        verbose=False)
    torch.cuda.synchronize()
    if len(records) != 6 or not all(
            np.isfinite(r[k]) and 0 <= r[k] for r in records
            for k in ('AQE', 'MQE', 'OQE')) or not all(
            r['AQE'] <= r['MQE'] for r in records):
        raise AssertionError(f'path K: quantzoo_benchmark {records}')
    summary['quantzoo'] = dict(records=records,
                               seconds=time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    absent = [row for row, k in PATH_K_ROWS.items() if launches.get(k, 0) <= 0]
    if absent:
        raise AssertionError(f'path K: rows {absent} did not launch')
    summary['launches_by_row'] = {row: launches[k]
                                  for row, k in PATH_K_ROWS.items()}
    summary['path_s'] = time.perf_counter() - t_path
    log(f'[path K] {json.dumps(summary)}')
    return launches, summary


def main_passes() -> int:
    """Path K alone: the quick loop for the passes and the analyses."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['fake_quant', 'histogram', 'floating'])
    launches, _ = phase_path_k(dev)
    log(f'[launches] path K {json.dumps(launches)}')
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------ path N
# path N: the rest of the single-card surface at ResNet-18's full width.
# Every registered platform quantizes the zoo ResNet-18 (batch 32 at 224²,
# API_CALIB seeded batches; the FP8 platforms with fp8_setting, as path C);
# the output's noise-to-signal ratio against fp32 and its top-1 agreement
# stay within a bound per kind: 8-bit as path A (SNR_INT8_BOUND), FP8 as
# path C (SNR_FP8_BOUND), INT4 weight-only 0.1 (0.051 in a CPU run
# at 4x3x96x96: 4-bit per-channel weights, float activations); top-1 at
# least 0.9 (0.75 for INT4; 1.0 for every platform on that CPU run).
API_CALIB = 4
API_KINDS = {'TPU_INT4_WEIGHT_ONLY': 'int4', 'TPU_FP8': 'fp8',
             'TRT_FP8': 'fp8', 'GRAPHCORE_FP8': 'fp8'}
API_SNR_BOUND = {'int8': SNR_INT8_BOUND, 'fp8': SNR_FP8_BOUND, 'int4': 0.1}
API_TOP1_BOUND = {'int8': 0.9, 'fp8': 0.9, 'int4': 0.75}
# the card against the CPU (a child process, `--api-cpu-reference`): every
# platform on a cut calibration set, 2 seeded batches of 8. States, policies
# and bit widths equal; scales that an observer takes from the parameter's
# own values with min / max bit for bit; the other scales (activations,
# derived biases) within API_CPU_RTOL, and the searches over histograms or
# candidate grids (KL, DirectMSE, the floating scales) within
# API_CPU_SEARCH_RTOL; an asymmetric offset within one code where its scale
# differs. The two bounds are set from readings on the H100: the searches'
# worst was 1.22e-6 (two runs, the seeded inputs picking the same bins on
# both devices), while a pick one candidate away moves the scale by 2.4e-4
# or more (one of KL's 4096 bins; 4.9e-4 for MSE's 2048; DirectMSE's
# candidates are powers of two), so a search that picks another fails.
API_CUT, API_CUT_BATCH = 2, 8
API_CPU_RTOL, API_CPU_SEARCH_RTOL = 1e-5, 1e-4
API_CPU_THREADS = 6
# QAT at ResNet-18's conv shapes: 4 calibration batches, then 20 SGD steps
# (momentum 0.9) on seeded labels, cycling over the 4 batches; the loss of
# the last 4 steps below that of the first 4. One step held against the
# same step through the plain versions: outputs bit for bit (the fake-quant
# forward is), gradients within QAT_PLAIN_TOL of each tensor's largest
# magnitude (the LSQ sums of rows 4 and 5 add in another order).
QAT_STEPS, QAT_LR, QAT_MOMENTUM, QAT_PLAIN_TOL = 20, 0.05, 0.9, 1e-4
API_BENCH_BATCHES = (1, 32, 256)
DATAIO_FILES = 16
PATH_N_ROWS = {'1': 'fake_quant_tensorwise', '2': 'fake_quant_channelwise',
               '3': 'histogram', '4': 'fake_quant_bwd_tensorwise',
               '5': 'fake_quant_bwd_channelwise', '6': 'floating_quant'}


def _api_setting(name):
    from ppq_tpu_torch.api import QuantizationSettingFactory
    return (QuantizationSettingFactory.fp8_setting()
            if API_KINDS.get(name) == 'fp8'
            else QuantizationSettingFactory.default_setting())


def _api_cut_set():
    rng = np.random.RandomState(70)
    return [rng.randn(API_CUT_BATCH, 3, IMAGE, IMAGE).astype(np.float32)
            for _ in range(API_CUT)]


def _api_tqcs(graph):
    """{(op, side, index): (state, policy, bits, observer, is parameter,
    scale, offset)} of every TQC that has a scale or a state."""
    out = {}
    for name, op in graph.operations.items():
        if not hasattr(op, 'config'):
            continue
        for side, variables in (('in', op.inputs), ('out', op.outputs)):
            cfgs = getattr(op.config, f'{side}put_quantization_config')
            for i, (var, cfg) in enumerate(zip(variables, cfgs)):
                scale = offset = None
                if cfg.has_scale:     # Python floats: torch.load takes them
                    scale = np.asarray(cfg.scale, np.float64).ravel().tolist()
                    offset = np.asarray(cfg.offset,
                                        np.float64).ravel().tolist()
                out[(name, side, i)] = (
                    cfg.state.name, int(cfg.policy), cfg.num_of_bits,
                    cfg.observer_algorithm, bool(var.is_parameter), scale,
                    offset)
    return out


def _api_quantize_all(device, loader, shape):
    """Every platform of QUANTIZER_COLLECTION on a fresh seeded ResNet-18:
    {platform: (graph, seconds)}."""
    from ppq_tpu_torch import quantize_graph
    from ppq_tpu_torch.quantization.quantizer import QUANTIZER_COLLECTION
    from ppq_tpu_torch.zoo import resnet18
    out = {}
    for platform in QUANTIZER_COLLECTION:
        graph = resnet18(input_shape=shape)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        quantize_graph(graph, loader, calib_steps=len(loader),
                       platform=platform, setting=_api_setting(platform.name),
                       verbose=False, device=device)
        if device.type == 'cuda':
            torch.cuda.synchronize()
        out[platform.name] = (graph, time.perf_counter() - t0)
    return out


def main_api_cpu_reference(out_path) -> int:
    """The CPU half of path N's card-versus-CPU check, run as a child
    process while the card works: every platform on the cut set on the CPU,
    its TQCs saved to out_path."""
    torch.set_num_threads(API_CPU_THREADS)
    shape = [API_CUT_BATCH, 3, IMAGE, IMAGE]
    t0 = time.perf_counter()
    graphs = _api_quantize_all(torch.device('cpu'), _api_cut_set(), shape)
    torch.save(dict(tqcs={k: _api_tqcs(g) for k, (g, _) in graphs.items()},
                    seconds=time.perf_counter() - t0), out_path + '.part')
    os.replace(out_path + '.part', out_path)
    return 0


def _api_cpu_reference():
    """`--api-cpu-reference` as a child process (API_CPU_THREADS cores)."""
    return _CpuReference('--api-cpu-reference')


def _api_card_vs_cpu(card, cpu):
    """Hold the card's TQCs of every platform against the CPU's; returns
    the largest relative scale difference by class."""
    worst = {'exact': 0.0, 'other': 0.0, 'search': 0.0}
    for platform, want_all in cpu.items():
        got_all = card[platform]
        if got_all.keys() != want_all.keys():
            raise AssertionError(f'path N: {platform} TQC sites differ')
        for key, want in want_all.items():
            got = got_all[key]
            if got[:5] != want[:5]:
                raise AssertionError(f'path N: {platform} {key} card '
                                     f'{got[:5]} CPU {want[:5]}')
            if want[5] is None:
                continue
            sg, sw = np.asarray(got[5]), np.asarray(want[5])
            rel = float(np.max(np.abs(sg - sw) / np.maximum(np.abs(sw),
                                                            1e-30)))
            observer, parameter, state = want[3], want[4], want[0]
            if parameter and observer == 'minmax' and \
                    not state.startswith('PASSIVE'):
                kind, bound = 'exact', 0.0
            elif observer in ('kl', 'floating', 'mse'):
                kind, bound = 'search', API_CPU_SEARCH_RTOL
            else:
                kind, bound = 'other', API_CPU_RTOL
            worst[kind] = max(worst[kind], rel)
            moved = np.abs(np.asarray(got[6]) - np.asarray(want[6]))
            if rel > bound or np.any(moved > (1 if rel > 0 else 0)):
                raise AssertionError(
                    f'path N: {platform} {key} ({observer}) scale card '
                    f'against CPU {rel:.3g} (bound {bound}), offsets moved '
                    f'{float(moved.max())}')
    return worst


def _api_platforms(dev, x, y_fp32, loader):
    """Step 1: every platform at full width, SNR and top-1 against fp32."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.quantization.measure import torch_snr_error
    graphs = _api_quantize_all(dev, loader, list(x.shape))
    rows = {}
    for name, (graph, seconds) in graphs.items():
        y = TorchExecutor(graph).forward(x)[0]
        if tuple(y.shape) != tuple(y_fp32.shape) or \
                not torch.isfinite(y).all():
            raise AssertionError(f'path N: {name} output {tuple(y.shape)}, '
                                 f'finite {bool(torch.isfinite(y).all())}')
        kind = API_KINDS.get(name, 'int8')
        snr = float(torch_snr_error(y, y_fp32))
        top1 = float((y.argmax(-1) == y_fp32.argmax(-1)).float().mean())
        rows[name] = dict(kind=kind, snr=snr, top1=top1,
                          quantize_s=seconds)
        if not (snr <= API_SNR_BOUND[kind] and top1 >= API_TOP1_BOUND[kind]):
            raise AssertionError(f'path N: {name} SNR {snr} (bound '
                                 f'{API_SNR_BOUND[kind]}), top-1 {top1} '
                                 f'(bound {API_TOP1_BOUND[kind]})')
    return graphs, rows


def _api_pfl(dev, graph, x):
    """Step 2: PFL on the TPU_INT8 graph's weights: ParameterQuant with an
    FP8 per-channel config (row 6's channelwise body), a power-of-2
    per-channel one (row 2) and an asymmetric per-tensor one (row 1), each
    weight's QuantFunction held bit for bit against the plain version; then
    the graph's forward with the FP8 weights."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch import lib as PFL
    from ppq_tpu_torch.kernels import floating_quant_plain, linear_quant_plain
    convs = [op for op in graph.operations.values() if op.type == 'Conv']
    configs = {
        'fp8_channel': lambda: PFL.FloatingQuantizationConfig(
            channel_axis=0, calibration='minmax'),
        'power_of_2': lambda: PFL.LinearQuantizationConfig(
            channel_axis=0, power_of_2=True),
        'asymmetric': lambda: PFL.LinearQuantizationConfig(
            symmetrical=False, quant_min=0, quant_max=255)}
    held = {k: 0 for k in configs}
    for op in convs:
        weight = op.inputs[1]
        w = torch.as_tensor(np.asarray(weight.value, np.float32), device=dev)
        for label, make in configs.items():
            cfg = make()
            if PFL.ParameterQuant(graph, weight.name, cfg) != 1:
                raise AssertionError(f'path N: ParameterQuant {label} on '
                                     f'{weight.name}')
            got = PFL.QuantFunction(w, cfg)
            scale = np.asarray(cfg.scale, np.float32)
            if label == 'fp8_channel':
                want = floating_quant_plain(w, scale, 4, 3, -448.0, 448.0, 0)
            else:
                offset = (np.asarray(cfg.offset, np.float32) if label ==
                          'asymmetric' else np.zeros_like(scale))
                want = linear_quant_plain(
                    w, scale, offset, cfg.quant_min, cfg.quant_max,
                    cfg.rounding, 0 if cfg.policy.per_channel else None)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f'path N: QuantFunction {label} on '
                                     f'{weight.name} != plain')
            held[label] += 1
    # the FP8 per-channel configs stay on the weights: the forward runs
    # row 6's channelwise body on every conv weight
    for op in convs:
        cfg = PFL.FloatingQuantizationConfig(channel_axis=0,
                                             calibration='minmax')
        PFL.ParameterQuant(graph, op.inputs[1].name, cfg)
    y = TorchExecutor(graph).forward(x)[0]
    if not torch.isfinite(y).all():
        raise AssertionError('path N: PFL forward not finite')
    return dict(held=held, convs=len(convs))


def _qat_model(dev):
    """QConv2d / QLinear at ResNet-18's conv shapes: the 7x7/2 stem to 64,
    the max pool, 3x3 stages of 64, 128, 256 and 512 (stride 2 from the
    second), the 1000-way head."""
    from ppq_tpu_torch import qat
    torch.manual_seed(0)
    return torch.nn.Sequential(
        qat.QConv2d(3, 64, 7, stride=2), torch.nn.ReLU(),
        torch.nn.MaxPool2d(3, 2, 1),
        qat.QConv2d(64, 64, 3), torch.nn.ReLU(),
        qat.QConv2d(64, 128, 3, stride=2), torch.nn.ReLU(),
        qat.QConv2d(128, 256, 3, stride=2), torch.nn.ReLU(),
        qat.QConv2d(256, 512, 3, stride=2), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
        qat.QLinear(512, 1000)).to(dev)


def _qat_step(model, x, label):
    model.zero_grad(set_to_none=True)
    y = model(x)
    loss = torch.nn.functional.cross_entropy(y, label)
    loss.backward()
    return y.detach(), loss.detach()


def _api_qat(dev, loader):
    """Step 3: calibrate, hold one step against the plain versions, then
    train QAT_STEPS steps."""
    import copy
    from ppq_tpu_torch import qat
    from ppq_tpu_torch.kernels import (LAUNCHES, linear_quant_bwd_plain,
                                       linear_quant_plain)
    from ppq_tpu_torch.quantization import qfunction
    gen = torch.Generator(device=dev).manual_seed(71)
    labels = [torch.randint(0, 1000, (x.shape[0],), device=dev,
                            generator=gen) for x in loader]
    model = _qat_model(dev)
    qat.QATController().calibrate(model, loader)
    scales = [float(layer.act_scale.detach())
              for layer in qat.qat_layers(model)]
    # one step, kernels against plain versions, outside the counts
    before = dict(LAUNCHES)
    twin = copy.deepcopy(model)
    y_k, _ = _qat_step(model, loader[0], labels[0])
    kernels = (qfunction.linear_quant, qfunction.linear_quant_bwd)
    qfunction.linear_quant, qfunction.linear_quant_bwd = \
        linear_quant_plain, linear_quant_bwd_plain
    try:
        y_p, _ = _qat_step(twin, loader[0], labels[0])
    finally:
        qfunction.linear_quant, qfunction.linear_quant_bwd = kernels
    if not torch.equal(y_k, y_p):
        raise AssertionError('path N: QAT outputs, kernels against plain')
    worst = 0.0
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        tol = QAT_PLAIN_TOL * float(q.grad.abs().max())
        diff = float((p.grad - q.grad).abs().max())
        worst = max(worst, diff / max(float(q.grad.abs().max()), 1e-30))
        if not diff <= tol:
            raise AssertionError(f'path N: QAT gradient of {name}, kernels '
                                 f'against plain, {diff} (bound {tol})')
    for k, v in before.items():
        LAUNCHES[k] = v
    del twin
    opt = torch.optim.SGD(model.parameters(), lr=QAT_LR,
                          momentum=QAT_MOMENTUM)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(QAT_STEPS):
        i = step % len(loader)
        _, loss = _qat_step(model, loader[i], labels[i])
        opt.step()
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f'path N: QAT losses {losses}')
    return dict(seeded_scales=scales, losses=losses,
                ms_per_step=seconds / QAT_STEPS * 1e3,
                plain_gradient_worst=worst)


def _api_deploy(dev, graph):
    """Step 4: the TPU_INT8 graph's 'highest' forward exported at batch 32,
    loaded and held bit for bit against the runner; benchmark_graph at
    API_BENCH_BATCHES; profile_graph's trace."""
    import tempfile
    from ppq_tpu_torch.executor import compile_graph
    from ppq_tpu_torch.utils import deploy
    out = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_deploy_') as tmp:
        path = os.path.join(tmp, 'resnet18_int8.pt2')
        t0 = time.perf_counter()
        deploy.export_compiled_artifact(graph, path, precision='highest')
        out['export_s'] = time.perf_counter() - t0
        out['artifact_mb'] = os.path.getsize(path) / 2 ** 20
        run = deploy.load_compiled_artifact(path)
        runner = compile_graph(graph, precision='highest').make_runner()
        gen = torch.Generator(device=dev).manual_seed(72)
        for _ in range(2):
            x = torch.randn(CALIB_BATCH, 3, IMAGE, IMAGE, device=dev,
                            generator=gen)
            got, want = run(x)[0], runner(x)[0]
            if not torch.equal(got, want):
                raise AssertionError(
                    f'path N: loaded artifact against the runner, '
                    f'{float((got - want).abs().max())}')
        del runner
        out['benchmark'] = deploy.benchmark_graph(
            graph, batch_sizes=API_BENCH_BATCHES, iters=10, warmup=2)
        logdir = deploy.profile_graph(graph, os.path.join(tmp, 'profile'),
                                      iters=3, batch=CALIB_BATCH)
        with open(os.path.join(logdir, 'trace.json')) as f:
            events = json.load(f).get('traceEvents', [])
        kernels = [e for e in events if e.get('cat') == 'kernel']
        if not kernels:
            raise AssertionError('path N: profile_graph traced no kernel')
        out['profile'] = dict(kernel_events=len(kernels), fake_quant_events=sum(
            'fake_quant' in e.get('name', '') for e in kernels))
    torch.cuda.empty_cache()
    return out


def _api_dataio(dev):
    """Step 5: DATAIO_FILES seeded .npy batches through the native loader
    into quantize_graph, against the same batches from memory."""
    import tempfile
    from ppq_tpu_torch import quantize_graph
    from ppq_tpu_torch.utils import load_calibration_dir
    from ppq_tpu_torch.zoo import resnet18
    rng = np.random.RandomState(73)
    batches = [rng.randn(CALIB_BATCH, 3, IMAGE, IMAGE).astype(np.float32)
               for _ in range(DATAIO_FILES)]
    shape = [CALIB_BATCH, 3, IMAGE, IMAGE]
    with tempfile.TemporaryDirectory(prefix='chip_smoke_npy_') as tmp:
        for i, b in enumerate(batches):
            np.save(os.path.join(tmp, f'batch_{i:03d}.npy'), b)
        loader = load_calibration_dir(tmp)
        if not loader.native:
            raise AssertionError('path N: the native npy loader did not build')
        tqcs, seconds = [], []
        for source in (loader, batches):
            graph = resnet18(input_shape=shape)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quantize_graph(graph, source, calib_steps=DATAIO_FILES,
                           verbose=False, device=dev)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            tqcs.append(_api_tqcs(graph))
    for key, want in tqcs[1].items():
        got = tqcs[0][key]
        if got[:5] != want[:5] or (want[5] is not None and not (
                np.array_equal(got[5], want[5]) and
                np.array_equal(got[6], want[6]))):
            raise AssertionError(f'path N: {key} from the npy loader differs '
                                 f'from the batches in memory')
    return dict(files=DATAIO_FILES, from_files_s=seconds[0],
                from_memory_s=seconds[1])


def phase_path_n(dev, reference):
    """Path N: every platform at full width, PFL, QAT, deploy, data I/O (see
    the constants above); the card's TQCs of every platform against the
    CPU's from `reference` (`_api_cpu_reference`)."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.quantization import qfunction
    from ppq_tpu_torch.zoo import resnet18
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    t_path = time.perf_counter()
    shape = [CALIB_BATCH, 3, IMAGE, IMAGE]
    gen = torch.Generator(device=dev).manual_seed(74)
    loader = [torch.randn(*shape, device=dev, generator=gen)
              for _ in range(API_CALIB)]
    x = torch.randn(*shape, device=dev, generator=gen)
    y_fp32 = TorchExecutor(resnet18(input_shape=shape)).forward(x)[0]
    summary, stages = {}, {}

    # row 6's launches by body, counted where qfunction calls the wrapper
    # (one LAUNCHES key holds both bodies), as path C counts them
    bodies = dict(channelwise=0, tensorwise=0)
    floating_quant = qfunction.floating_quant

    def by_body(x, scale, e_bits, m_bits, qmin, qmax, channel_axis=None):
        if x.is_cuda and x.numel():
            bodies['tensorwise' if channel_axis is None
                   else 'channelwise'] += 1
        return floating_quant(x, scale, e_bits, m_bits, qmin, qmax,
                              channel_axis)

    qfunction.floating_quant = by_body
    reset_launches()
    try:
        t0 = time.perf_counter()
        graphs, summary['platforms'] = _api_platforms(dev, x, y_fp32, loader)
        stages['platforms_s'] = time.perf_counter() - t0
        int8 = graphs.pop('TPU_INT8')[0]
        del graphs
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        summary['deploy'] = _api_deploy(dev, int8)
        stages['deploy_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary['pfl'] = _api_pfl(dev, int8, x)
        stages['pfl_s'] = time.perf_counter() - t0
        del int8
        t0 = time.perf_counter()
        summary['qat'] = _api_qat(dev, loader)
        stages['qat_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        summary['dataio'] = _api_dataio(dev)
        stages['dataio_s'] = time.perf_counter() - t0
    finally:
        qfunction.floating_quant = floating_quant
    launches = dict(LAUNCHES)
    rows = {row: launches[k] for row, k in PATH_N_ROWS.items()}
    rows['6t'], rows['6c'] = bodies['tensorwise'], bodies['channelwise']
    absent = [row for row, n in rows.items() if n <= 0]
    if absent:
        raise AssertionError(f'path N: rows {absent} did not launch: {rows}')
    summary['launches_by_row'] = rows
    # the card's TQCs against the CPU's, on the cut set, outside the counts
    t0 = time.perf_counter()
    cut = [torch.as_tensor(b, device=dev) for b in _api_cut_set()]
    card = {k: _api_tqcs(g) for k, (g, _) in _api_quantize_all(
        dev, cut, [API_CUT_BATCH, 3, IMAGE, IMAGE]).items()}
    ref = reference.result()
    summary['card_vs_cpu'] = dict(
        worst_rel=_api_card_vs_cpu(card, ref['tqcs']),
        platforms=len(ref['tqcs']), cpu_s=ref['seconds'],
        waited_s=time.perf_counter() - t0)
    stages['path_s'] = time.perf_counter() - t_path
    summary['stages'] = stages
    log(f'[path N] {json.dumps(summary)}')
    return launches, summary


def main_api() -> int:
    """Path N alone."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    reference = _api_cpu_reference()
    try:
        phase_build(['fake_quant', 'histogram', 'fake_quant_bwd', 'floating'])
        launches, _ = phase_path_n(dev, reference)
    finally:
        reference.close()
    log(f'[launches] path N {json.dumps(launches)}')
    _check_path_kernels('N', launches)
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------ --fp8-sample
# DirectMSE's sample (ROADMAP.md queue 3 item 36): path C's FP8 calibration
# of ResNet-18 and BERT-base's (path J's) at these batch sizes
FP8_SAMPLE_BERT_BATCHES = (4, 8, 16, 32)


def _jax_sample_stride(value):
    """The JAX package's DirectMSE stride: the size over 4096."""
    return max(1, value.numel() // 4096)


def _floating_scales(graph):
    """Every floating TQC's scale, by op, side and index."""
    return {f'{op.name}:{side}{i}': np.asarray(c.scale).reshape(-1).tolist()
            for op in graph.operations.values() if hasattr(op, 'config')
            for side, cfgs in (('in', op.config.input_quantization_config),
                               ('out', op.config.output_quantization_config))
            for i, c in enumerate(cfgs) if c.policy.floating and c.has_scale}


def _fp8_sample_resnet(dev):
    """Path C's quantize_graph and SNR against fp32."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.zoo import resnet18
    shape, loader, x_eval = _data()
    x_dev = torch.as_tensor(x_eval, device=dev)
    graph = resnet18(input_shape=shape)
    quantize_graph(graph, loader[:TRAIN_BATCHES], calib_steps=TRAIN_BATCHES,
                   platform=TargetPlatform.TPU_FP8,
                   setting=QuantizationSettingFactory.fp8_setting(),
                   verbose=False)
    _, snr, top1 = _forward_vs(graph, x_dev, _fp32_forward(shape, x_dev))
    return dict(snr_fp8=snr, top1_agree_fp8=top1), _floating_scales(graph)


def _fp8_sample_bert(dev, batch):
    """Path J's FP8 quantize_graph of BERT-base at `batch`, and its SNR
    against fp32."""
    from ppq_tpu_torch import TargetPlatform, TorchExecutor, quantize_graph
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.api import QuantizationSettingFactory
    graph = zoo.bert_encoder(batch=batch, **BERT_BASE)
    x_eval = _bert_batches(dev, 1, seed=1, batch=batch)[0]
    y_fp32 = TorchExecutor(graph).forward(x_eval)[0]
    quantize_graph(graph, _bert_batches(dev, BERT_FP8_STEPS, 0, batch),
                   calib_steps=BERT_FP8_STEPS,
                   platform=TargetPlatform.TPU_FP8,
                   setting=QuantizationSettingFactory.fp8_setting(),
                   verbose=False)
    snr, top1 = _snr_and_top1(TorchExecutor(graph).forward(x_eval)[0], y_fp32)
    return dict(snr_fp8=snr, top1_agree_fp8=top1)


def main_fp8_sample(package_root=None) -> int:
    """Path C's FP8 calibration, and BERT-base's where the package has it,
    under DirectMSE's sample rules: the package's own, and where it has
    `observers.sample_stride`, the JAX package's stride in its place. Each
    rule's SNRs against fp32 and every floating scale go to
    chiprun_out/fp8_sample_<package directory>.json, the scales that the
    rules set apart to the log."""
    name, smi = phase_card()
    if package_root:
        sys.path.insert(0, package_root)
    import ppq_tpu_torch
    from ppq_tpu_torch import zoo
    from ppq_tpu_torch.quantization import observers
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['fake_quant', 'histogram', 'floating'])
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        ppq_tpu_torch.__file__)))
    rules = {'own': None}
    own = getattr(observers, 'sample_stride', None)
    if own is not None:
        rules['jax_stride'] = _jax_sample_stride
    out = dict(package=root, rules={})
    for rule, stride in rules.items():
        if stride is not None:
            observers.sample_stride = stride
        try:
            resnet, scales = _fp8_sample_resnet(dev)
            bert = ({b: _fp8_sample_bert(dev, b)
                     for b in FP8_SAMPLE_BERT_BATCHES}
                    if hasattr(zoo, 'bert_encoder') else 'not in the package')
        finally:
            if stride is not None:
                observers.sample_stride = own
        out['rules'][rule] = dict(resnet18=resnet, bert_base=bert,
                                  scales=scales)
        log(f'[fp8 sample] {root} {rule}: '
            f'{json.dumps(dict(resnet18=resnet, bert_base=bert))}')
    if 'jax_stride' in out['rules']:
        a = out['rules']['jax_stride']['scales']
        b = out['rules']['own']['scales']
        moved = {k: [a[k], b[k]] for k in b if a[k] != b[k]}
        log(f'[fp8 sample] ResNet-18 scales the stride moves (JAX stride, '
            f'own): {len(moved)} of {len(b)} {json.dumps(moved)}')
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'fp8_sample_'
                           f'{os.path.basename(root)}.json'), 'w') as f:
        json.dump(out, f, indent=1)
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


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


def _path_inputs(dev):
    """What rows 2 and 3 are given on path A, recorded from quantize_graph
    (KL, one batch of _data()) on the zoo ResNet-18 at full width: the 21
    weights that a calibration batch fake-quantizes channelwise, each on its
    own axis with its scales, and the 41 activations that a KL phase-2
    batch histograms, each with its scale (4096 bins)."""
    from ppq_tpu_torch import TargetPlatform, quantize_graph
    from ppq_tpu_torch.api import QuantizationSettingFactory
    from ppq_tpu_torch.quantization import observers, qfunction
    from ppq_tpu_torch.zoo import resnet18
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    weights, acts, calls = [], [], [0]
    linear_quant, histogram = qfunction.linear_quant, observers.histogram

    def record_quant(x, scale, offset, qmin, qmax, rounding, channel_axis=None,
                     codes=False):
        # each sweep of the calibration batch quantizes the 21 weights once
        calls[0] += channel_axis is not None
        if channel_axis is not None and len(weights) < 21:
            weights.append(dict(
                x=x.clone(), scale=torch.as_tensor(scale, device=dev).clone(),
                offset=torch.as_tensor(offset, device=dev).clone(),
                qmin=qmin, qmax=qmax, rounding=rounding, axis=channel_axis))
        return linear_quant(x, scale, offset, qmin, qmax, rounding,
                            channel_axis, codes)

    def record_histogram(x, scale, bins, absolute=True, out=None):
        acts.append(dict(x=x.clone(), scale=scale, bins=bins,
                         absolute=absolute))
        return histogram(x, scale, bins, absolute, out)

    shape, loader, _ = _data()
    setting = QuantizationSettingFactory.default_setting()
    setting.quantize_activation_setting.calib_algorithm = 'kl'
    qfunction.linear_quant, observers.histogram = record_quant, record_histogram
    try:
        with _observer_path():
            quantize_graph(resnet18(input_shape=shape), loader[:1],
                           calib_steps=1, platform=TargetPlatform.TPU_INT8,
                           setting=setting, verbose=False)
    finally:
        qfunction.linear_quant, observers.histogram = linear_quant, histogram
    torch.cuda.synchronize()
    if calls[0] != 42 or len(acts) != 41:
        raise AssertionError(f'path A gave {calls[0]} channelwise fake-quants '
                             f'and {len(acts)} histograms, not 2 x 21 and 41')
    return weights, acts


def _row6c_at_weights(weights, row2, flush):
    """Row 6c, the channelwise floating fake-quant, at the 21 weights path B
    trains (each on its own axis), with per-channel scales from each
    channel's absmax / qmax: bit-equal to the plain version for E4M3, E5M2
    and E3M4, two calls bit-equal, then timed in E4M3 beside row 2's time
    at the same weight (`row2`: quant_paths' rows)."""
    from ppq_tpu_torch.kernels import floating_quant, floating_quant_plain
    rows = []
    for w, r2 in zip(weights, row2):
        x, axis = w['x'], w['axis']
        dims = [i for i in range(x.ndim) if i != axis]
        absmax = x.abs().amax(dim=dims)
        for e, m, qmax in ((4, 3, 448.0), (5, 2, 57344.0), (3, 4, 15.5)):
            s = absmax / qmax
            got = floating_quant(x, s, e, m, -qmax, qmax, axis)
            want = floating_quant_plain(x, s, e, m, -qmax, qmax, axis)
            again = floating_quant(x, s, e, m, -qmax, qmax, axis)
            if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                    and torch.equal(again.view(torch.int32),
                                    got.view(torch.int32))):
                raise AssertionError(f'floating_quant channelwise != plain at '
                                     f'{tuple(x.shape)} axis {axis}, E{e}M{m}')
        s = absmax / 448.0
        ms = time_ms(lambda: floating_quant(x, s, 4, 3, -448.0, 448.0, axis),
                     flush)
        n = x.numel()
        b, _ = bound_ms(8.0 * n + 4.0 * x.shape[axis], 12.0 * n)
        rows.append(dict(shape=list(x.shape), axis=axis, ms=ms, bound_ms=b,
                         row_2_ms=r2['ms']))
    out = dict(per_shape=rows, sum_ms=sum(r['ms'] for r in rows),
               row_2_sum_ms=sum(r['row_2_ms'] for r in rows),
               sum_bound_ms=sum(r['bound_ms'] for r in rows))
    log(f'[quant] row 6c at the 21 weights path B trains, bit-equal (E4M3, '
        f'E5M2, E3M4), two calls bit-equal: sum {out["sum_ms"]:.4f} ms, row 2 '
        f'{out["row_2_sum_ms"]:.4f} ms (bounds {out["sum_bound_ms"]:.4f}); '
        + ', '.join(f'{r["shape"]}@{r["axis"]} {r["ms"]:.4f} (row 2 '
                    f'{r["row_2_ms"]:.4f})' for r in rows))
    return out


def _row5_at_weights(weights, flush):
    """Row 5 at each weight path B's LSQ trains channelwise (the 21 that
    path A's calibration quantizes, with their scales), with a seeded
    gradient: dx bit-equal to the plain version, ds and do within the
    float64 sums' tolerance, two calls bit-equal, then timed."""
    from ppq_tpu_torch.core import RoundingPolicy
    from ppq_tpu_torch.kernels import linear_quant_bwd
    from ppq_tpu_torch.kernels.quant import linear_quant_bwd_terms
    gen = torch.Generator(device=flush.device).manual_seed(5)
    rows = []
    for w in weights:
        x, axis = w['x'], w['axis']
        g = torch.randn(x.shape, device=x.device, generator=gen)
        dims = [i for i in range(x.ndim) if i != axis]
        args = (w['scale'], w['offset'], w['qmin'], w['qmax'])
        for policy in (w['rounding'], RoundingPolicy.ROUND_HALF_UP):
            got = linear_quant_bwd(x, g, *args, policy, axis)
            again = linear_quant_bwd(x, g, *args, policy, axis)
            want, ds_e, do_e = linear_quant_bwd_terms(x, g, *args, policy, axis)
            if not torch.equal(got[0].view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f'fake_quant_bwd_channelwise: dx != plain '
                                     f'at {tuple(x.shape)} axis {axis}')
            for a, b in zip(got, again):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError('fake_quant_bwd_channelwise: two calls '
                                         'differ')
            _check_sums('fake_quant_bwd_channelwise', got[1], ds_e, dims)
            _check_sums('fake_quant_bwd_channelwise', got[2], do_e, dims)
        ms = time_ms(lambda: linear_quant_bwd(x, g, *args, w['rounding'], axis),
                     flush)
        n = x.numel()
        b, _ = bound_ms(12.0 * n + 16.0 * x.shape[axis], 14.0 * n)
        rows.append(dict(shape=list(x.shape), axis=axis, ms=ms, bound_ms=b))
    out = dict(per_shape=rows, sum_ms=sum(r['ms'] for r in rows),
               sum_bound_ms=sum(r['bound_ms'] for r in rows))
    log(f'[quant] row 5 at the 21 weights path B trains, dx bit-equal, sums '
        f'within tolerance, two calls bit-equal (2 policies): sum '
        f'{out["sum_ms"]:.4f} ms (bounds {out["sum_bound_ms"]:.4f}); '
        + ', '.join(f'{r["shape"]}@{r["axis"]} {r["ms"]:.4f}' for r in rows))
    return out


def quant_paths(dev, flush, measure):
    """`--quant` only: rows 2 and 3 at every input path A gives them (each
    held against its plain version, then timed, row 3 into running counts
    as the observers call it), with the sums a calibration batch spends;
    rows 6c and 5 at the same 21 weights (`_row6c_at_weights`,
    `_row5_at_weights`);
    row 3 also at 2048 bins (the MSE observers). With the measurement
    build (`measure`), row 3's bin variants (product or IEEE quotient,
    counting or not) on the headline activation and on the real first-ReLU
    activation."""
    from ppq_tpu_torch.core import RoundingPolicy
    from ppq_tpu_torch.kernels import (histogram, histogram_plain, linear_quant,
                                       linear_quant_plain, loader)
    weights, acts = _path_inputs(dev)
    results = {}
    rows = []
    for w in weights:
        x, axis = w['x'], w['axis']
        args = (w['scale'], w['offset'], w['qmin'], w['qmax'])
        for policy in (w['rounding'], RoundingPolicy.ROUND_HALF_UP):
            for codes in (False, True):
                got = linear_quant(x, *args, policy, axis, codes)
                want = linear_quant_plain(x, *args, policy, axis, codes)
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise AssertionError(f'fake_quant_channelwise != plain at '
                                         f'{tuple(x.shape)} axis {axis}')
        first = linear_quant(x, *args, w['rounding'], axis)
        again = linear_quant(x, *args, w['rounding'], axis)
        if not torch.equal(first.view(torch.int32), again.view(torch.int32)):
            raise AssertionError('fake_quant_channelwise: two calls differ')
        ms = time_ms(lambda: linear_quant(x, *args, w['rounding'], axis), flush)
        n = x.numel()
        b, _ = bound_ms(8.0 * n + 8.0 * x.shape[axis], 7.0 * n)
        rows.append(dict(shape=list(x.shape), axis=axis, ms=ms, bound_ms=b))
    results['row 2 path A weights'] = dict(
        per_shape=rows, sum_ms=sum(r['ms'] for r in rows),
        sum_bound_ms=sum(r['bound_ms'] for r in rows))
    log(f'[quant] row 2 at the 21 weights of a calibration batch, bit-equal '
        f'(2 policies x codes on and off): sum '
        f'{results["row 2 path A weights"]["sum_ms"]:.4f} ms (bounds '
        f'{results["row 2 path A weights"]["sum_bound_ms"]:.4f}); '
        + ', '.join(f'{r["shape"]}@{r["axis"]} {r["ms"]:.4f}' for r in rows))
    results['row 6c path B weights'] = _row6c_at_weights(weights, rows, flush)
    results['row 5 path B weights'] = _row5_at_weights(weights, flush)

    first_relu = None
    for bins in (4096, 2048):
        rows = []
        counts = torch.zeros(bins, dtype=torch.int64, device=dev)
        for a in acts:
            x = a['x']
            scale = float(np.float32(a['scale']) * np.float32(a['bins'] / bins))
            got = histogram(x, scale, bins, a['absolute'])
            want = histogram_plain(x, scale, bins, a['absolute'])
            again = histogram(x, scale, bins, a['absolute'])
            if not (torch.equal(got, want) and torch.equal(again, want)):
                raise AssertionError(f'histogram != plain at {tuple(x.shape)}, '
                                     f'{bins} bins')
            ms = time_ms(lambda: histogram(x, scale, bins, a['absolute'], counts),
                         flush)
            n = x.numel()
            b, _ = bound_ms(4.0 * n + 8.0 * bins, 3.0 * n)
            rows.append(dict(shape=list(x.shape), ms=ms, bound_ms=b,
                             bin0_share=float(want[0]) / n))
            if tuple(x.shape) == ACT_SHAPE and bins == 4096:
                first_relu = (x, scale)
        key = f'row 3 path A activations, {bins} bins'
        results[key] = dict(per_shape=rows, sum_ms=sum(r['ms'] for r in rows),
                            sum_bound_ms=sum(r['bound_ms'] for r in rows))
        log(f'[quant] {key}, count-exact, two calls equal: sum '
            f'{results[key]["sum_ms"]:.4f} ms (bounds '
            f'{results[key]["sum_bound_ms"]:.4f}); '
            + ', '.join(f'{r["shape"]} {r["ms"]:.4f} (bin 0 '
                        f'{r["bin0_share"]:.2f})' for r in rows))
    del weights

    if measure and first_relu is not None:
        lib = loader.library('histogram_measure')
        stream = loader.stream_of(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        headline = torch.relu(torch.randn(*ACT_SHAPE, device=dev, generator=gen) * 2.0)
        inputs = (('headline post-ReLU randn', headline,
                   float(headline.max()) / 4096),
                  ('real first-ReLU activation',) + first_relu)
        out = torch.zeros(4096, dtype=torch.int64, device=dev)
        variants = (('kernel (product bin)', 1, 1),
                    ('IEEE quotient bin', 0, 1),
                    ('no counting (bins computed, no atomic)', 1, 0),
                    ('no counting, IEEE quotient bin', 0, 0))
        for label, x, scale in inputs:
            timed = {}
            for name, fast, count in variants:
                def run():
                    rc = lib.ppq_histogram_variant(
                        x.data_ptr(), x.numel(), scale, 4096, out.data_ptr(),
                        fast, count, stream)
                    if rc:
                        raise AssertionError(f'histogram variant {name}: {rc}')
                if count:
                    out.zero_()
                    run()
                    if not torch.equal(out, histogram_plain(x, scale, 4096)):
                        raise AssertionError(f'histogram variant {name} != plain')
                timed[name] = time_ms(run, flush)
            results[f'row 3 variants, {label}'] = timed
            log(f'[quant] row 3 variants on the {label} (4096 bins, into '
                f'running counts): '
                + '; '.join(f'{k} {v:.4f}' for k, v in timed.items()))
        del headline, first_relu
    del acts
    torch.cuda.empty_cache()
    return results


def _device_events(label, call):
    """The device events (kernels, copies) of one call of `call`, by
    torch.profiler, logged under `label`; returns their number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = {e.key: e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count}
    log(f'{label}, device events of one call: {sum(events.values())} '
        f'{json.dumps(events)[:300]}')
    return sum(events.values())


def _row5_device_events(weight, g):
    """The device events of one row-5 call at the headline weight, scales
    and offsets already on the card as LSQ trains them: what a call adds to
    an LSQ step's count."""
    from ppq_tpu_torch.core import RoundingPolicy
    from ppq_tpu_torch.kernels import linear_quant_bwd
    channels = weight.shape[0]
    s = torch.full((channels,), 1e-3, device=weight.device)
    o = torch.zeros(channels, device=weight.device)
    return _device_events('[quant] row 5', lambda: linear_quant_bwd(
        weight, g, s, o, -128, 127, RoundingPolicy.ROUND_HALF_EVEN, 0))


def _measure_libraries(sources):
    """Register the measurement builds of `sources` (nvcc -DPPQ_MEASURE)
    beside the package's own libraries, under their own names and with
    their flags: variants that explain a time (row 2's loads and stores
    alone, row 3's bin and counting variants, row 5's traffic without its
    arithmetic), an empty launch and a pair of empty launches that differ
    in the size of their arguments. The package's libraries stay as the
    paths run them. Returns the names registered: a source without such a
    build, or with other entry points (an older commit), is left out."""
    import ctypes
    from ppq_tpu_torch.kernels import loader
    P, I64, F, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
    entries = {
        'fake_quant.cu': ('fake_quant_measure', {
            'ppq_fake_quant_channelwise_copy': [P, P, I64, I64, I64, P]}),
        'histogram.cu': ('histogram_measure', {
            'ppq_histogram_variant': [P, I64, F, INT, P, INT, INT, P],
            'ppq_empty_launch': [P]}),
        'fake_quant_bwd.cu': ('fake_quant_bwd_measure', {
            'ppq_fake_quant_bwd_channelwise_copy':
                [P, P, P, I64, I64, I64, INT, INT, P, P, P, P, P]}),
        'kv_write.cu': ('kv_write_measure', {
            'ppq_empty_launch_args': [INT, P]}),
        'paged_attention.cu': ('paged_attention_measure', {
            'ppq_paged_attention_buffered_measure':
                [P] * 13 + [I64] * 15 + [F, INT, INT, P]}),
    }
    names = []
    for source in sources:
        name, fns = entries[source]
        with open(os.path.join(loader.SRC_DIR, source)) as f:
            text = f.read()
        if 'PPQ_MEASURE' not in text or not all(fn in text for fn in fns):
            continue
        flags, = [lib[2] for lib in loader.LIBRARIES.values()
                  if lib[0] == source]
        loader.LIBRARIES[name] = (source, fns, [*flags, '-DPPQ_MEASURE'])
        names.append(name)
    return names


def main_quant(package_root=None) -> int:
    """`--quant`: the card, the build of the fake-quant and histogram
    kernels, rows 1-7 held and timed at their headline shapes as the full
    smoke times them (kernels_quant: row 3 into a fresh output), row 3 at
    its headline into running counts, and rows 2 and 3 at every input path
    A gives them (quant_paths); with yardsticks over the same bytes (a
    float32 clone of the weight for row 2, a float32 sum of the activation
    for row 3, a `torch.mul` into a given output for row 5), rows 6c and 5
    at the 21 weights path B trains and, where the checkout has the measurement
    build, row 2's loads and stores alone, row 5's without its arithmetic,
    and the launch floor (`ppq_empty_launch`). With
    `--package-root DIR` the package is imported from the checkout at DIR,
    so two commits are timed in one call on one card, in turns."""
    t_start = time.perf_counter()
    _, smi = phase_card()
    if package_root:
        sys.path.insert(0, package_root)
    import ppq_tpu_torch
    log(f'[quant] package {ppq_tpu_torch.__file__}')
    from ppq_tpu_torch.kernels import histogram, loader
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    measure = _measure_libraries(('fake_quant.cu', 'histogram.cu',
                                  'fake_quant_bwd.cu'))
    phase_build(['fake_quant', 'fake_quant_bwd', 'floating', 'histogram']
                + measure)
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    results = kernels_quant(dev, flush)
    _log_kernels(results)
    # the same inputs as kernels_quant's
    gen = torch.Generator(device=dev).manual_seed(0)
    act = torch.randn(*ACT_SHAPE, device=dev, generator=gen) * 2.0
    weight = torch.randn(*WEIGHT_SHAPE, device=dev, generator=gen) * 0.05
    post_relu = torch.relu(act)
    running = {}
    for bins in (4096, 2048):
        scale = float(post_relu.max()) / bins
        counts = torch.zeros(bins, dtype=torch.int64, device=dev)
        running[bins] = time_ms(lambda: histogram(post_relu, scale, bins,
                                                  out=counts), flush)
    results['row 3 headline into running counts'] = running
    log(f'[quant] row 3 at {list(ACT_SHAPE)} into running counts: '
        f'4096 bins {running[4096]:.4f} ms, 2048 bins {running[2048]:.4f} ms')
    del post_relu
    results.update(quant_paths(dev, flush, 'histogram_measure' in measure))
    stream = loader.stream_of(dev)
    g = torch.randn(weight.shape, device=dev, generator=gen)
    dx = torch.empty_like(weight)
    results['yardsticks'] = dict(
        weight_clone_ms=time_ms(lambda: weight.clone(), flush),
        activation_sum_ms=time_ms(lambda: act.sum(), flush),
        # the same 12 bytes an element as row 5, in one launch
        weight_mul_ms=time_ms(lambda: torch.mul(weight, g, out=dx), flush))
    results['row 5 device events per call'] = _row5_device_events(weight, g)
    if 'histogram_measure' in measure:
        results['yardsticks']['launch_floor_ms'] = time_ms(
            lambda: loader.library('histogram_measure').ppq_empty_launch(stream),
            flush)
    channels = WEIGHT_SHAPE[0]
    inner = weight.numel() // channels
    if 'fake_quant_measure' in measure:
        # row 2's kernel with its loads and stores alone, at the headline
        y = torch.empty_like(weight)

        def copy():
            if loader.library('fake_quant_measure').ppq_fake_quant_channelwise_copy(
                    weight.data_ptr(), y.data_ptr(), weight.numel(), channels,
                    inner, stream):
                raise AssertionError('row 2 copy variant refused')
        copy()
        if not torch.equal(y, weight):
            raise AssertionError('row 2 copy variant != its input')
        results['yardsticks']['row_2_copy_only_ms'] = time_ms(copy, flush)
    if 'fake_quant_bwd_measure' in measure:
        # row 5's kernel on its own plan, dx = g and the sums of x and g:
        # its loads, stores and reductions without the arithmetic, at the
        # headline weight and at the classifier's layout (channels last)
        from ppq_tpu_torch.kernels.quant import channelwise_bwd_plan, _bwd_workspace
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lib = loader.library('fake_quant_bwd_measure')
        fc = torch.randn(512, 1000, device=dev, generator=gen)
        for key, x, channels, outer, inner in (
                ('row_5_traffic_only_ms', weight, channels, 1, inner),
                ('row_5_traffic_only_512x1000_axis1_ms', fc, 1000, 512, 1)):
            grad = torch.randn(x.shape, device=dev, generator=gen)
            out = torch.empty_like(x)
            plan = channelwise_bwd_plan(channels, outer, inner, True, sms)
            work = _bwd_workspace(dev, plan) if plan.splits > 1 else (None, None)
            sums = torch.empty(2, channels, device=dev)

            def bwd_copy():
                if lib.ppq_fake_quant_bwd_channelwise_copy(
                        x.data_ptr(), grad.data_ptr(), out.data_ptr(),
                        x.numel(), channels, inner, plan.vec, plan.splits,
                        *work, sums.data_ptr(), sums.data_ptr() + 4 * channels,
                        stream):
                    raise AssertionError('row 5 copy variant refused')
            bwd_copy()
            if not torch.equal(out, grad):
                raise AssertionError('row 5 copy variant: dx != g')
            results['yardsticks'][key] = time_ms(bwd_copy, flush)
        del fc
    log(f'[quant] yardsticks: {json.dumps(results["yardsticks"])}')
    log(f'[done] {time.perf_counter() - t_start:.1f} s; {smi}')
    log(json.dumps({'quant': results, 'card': smi}))
    return 0


def main_qmm(package_root=None) -> int:
    """`--qmm`: the card, the build and the dequant-matmuls' kernel phase
    alone (rows 8 and 10 at path D's shapes, kernels_qmm; rows 9 and 10's
    INT4 body at path F's, kernels_int4) and the split sweep, the quick loop
    for work on those kernels. With
    `--package-root DIR` the package is imported from the checkout at DIR
    (another commit's tree), so two commits are timed in one call on one
    card, in turns."""
    t_start = time.perf_counter()
    _, smi = phase_card()
    if package_root:
        sys.path.insert(0, package_root)
    import ppq_tpu_torch
    log(f'[qmm] package {ppq_tpu_torch.__file__}')
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['qmm'])
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    results = kernels_qmm(dev, flush)
    results.update(kernels_int4(dev, flush))
    if hasattr(sys.modules['ppq_tpu_torch.kernels.qmm'], '_splits'):
        qmm_sweep(dev, flush)
    log(f'[done] {time.perf_counter() - t_start:.1f} s; {smi}')
    log(json.dumps({'qmm': results, 'card': smi}))
    return 0


def main_attention(package_root=None) -> int:
    """`--attention`: the card, the build of the paged-attention and KV
    write kernels, rows 11 and 12 alone at the paths' four shapes
    (kernels_attention), row 14 at path D's (kernels_bank) beside a
    contiguous copy of the same bytes and the launch floor (and, where the
    checkout has the measurement build, empty launches with a 2 KiB and a
    16-byte argument block), with row 13 (and row 16, which shares its
    pool) at path G's (kernels_paged: fills 512 and 16, steps 0 and 31,
    beside the engine's composition with and without its share of the
    burst's repack, and, where the checkout has the measurement build,
    row 13's copies alone and its one-warp-a-head layout at fill 16): the
    quick loop for work on those kernels. With
    `--package-root DIR` the package is imported from the checkout at DIR,
    so two commits are timed in one call on one card, in turns."""
    t_start = time.perf_counter()
    _, smi = phase_card()
    if package_root:
        sys.path.insert(0, package_root)
    import ppq_tpu_torch
    log(f'[attention] package {ppq_tpu_torch.__file__}')
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    measure = _measure_libraries(('kv_write.cu', 'paged_attention.cu'))
    phase_build(['paged_attention', 'kv_write'] + measure)
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    results = kernels_attention(dev, flush)
    results['row 14 at path D'] = row14 = kernels_bank(dev, flush)['bank_write']
    from ppq_tpu_torch.kernels import loader
    stream = loader.stream_of(dev)
    src = torch.randint(-128, 128, (4 * 2 ** 20,), dtype=torch.int8, device=dev)
    dst = torch.empty_like(src)
    row14['yardsticks'] = dict(
        # the same 4 MiB read and written, in one launch
        contiguous_copy_ms=time_ms(lambda: dst.copy_(src), flush),
        launch_floor_ms=time_ms(
            lambda: loader.library('paged_attention').ppq_empty_launch(stream),
            flush))
    if 'kv_write_measure' in measure:
        lib = loader.library('kv_write_measure')
        for table, key in ((1, 'empty_2KiB_args_ms'), (0, 'empty_16B_args_ms')):
            row14['yardsticks'][key] = time_ms(
                lambda: lib.ppq_empty_launch_args(table, stream), flush)
    log(f'[attention] row 14: {row14["ms"]:.4f} ms, bound '
        f'{row14["bound_ms"]:.4f} ms, yardsticks {json.dumps(row14["yardsticks"])}')
    del src, dst
    paged = kernels_paged(dev, flush, detail=True,
                          measure='paged_attention_measure' in measure)
    row13 = paged['paged_attention_buffered']
    results['row 13 fill 512 + 32 buffer columns'] = {
        k: row13[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                              'bound_by', 'max_abs_err',
                              'worst_share_of_tolerance',
                              'worst_share_against_composition')}
    for key in ('row 13 cells', 'row 13 variants'):
        if key in paged:
            results[key] = paged[key]
    log(f'[attention] row 13: {row13["ms"]:.4f} ms, bound '
        f'{row13["bound_ms"]:.4f} ms, plain {row13["plain_ms"]:.4f} ms, worst '
        f'share of the tolerance {row13["worst_share_of_tolerance"]:.3f} '
        f'(plain), {row13["worst_share_against_composition"]:.3f} (twice it, '
        f'composition)')
    log(f'[done] {time.perf_counter() - t_start:.1f} s; {smi}')
    log(json.dumps({'attention': results, 'card': smi}))
    return 0


# ---------------------------------------------------------------- path M --
# bench.py's 1B decoder (bench.py:399-407) at full width: float weights from
# init_llama_params(quantized=False, seed=0), the calibrated quantizers on the
# card beside round-to-nearest, their engines, W8A8, MoE and speculative
# decoding. The engines keep 32 slots (path D's 128 are timed there), and
# CUT_LAYERS of the 16 layers.
LLM = dict(CUT_SERVE, max_batch=32)
LLM_CALIB, LLM_EVAL = (4, 128), (2, 128)
LLM_REQUESTS, LLM_NEW_TOKENS = 16, 32
# the MoE engine at the same widths, 8 experts top-2: depth cut to 2 layers
# for the smoke's time (its expert stacks are 0.55 G INT8 parameters at 2
# layers; drawing them with numpy takes most of its build)
LLM_MOE = dict(LLM, n_layers=2, n_experts=8, top_k=2)
SPEC_K, SPEC_TOKENS, SPEC_DRAFT_LAYERS = 4, 48, 2
# the card-versus-CPU check of AWQ and GPTQ: the same widths at 2 layers, an
# INT8 lm_head quantized before (the quantizers then leave it alone)
LLM_CHECK = dict(LLM, n_layers=2, weight_bits=4)
# what may differ between the card's AWQ / GPTQ and the CPU's: the
# calibration captures, the products and GPTQ's H, inverse and Cholesky
# factor sum in each device's order, and so does the mse scale search's
# error per channel (recorded difference 44). AWQ: every alpha's error on
# the card lies within 1 % of the CPU's; a group whose chosen alpha differs
# is a near-tie when the card's gap between the two alphas is no larger
# than how far the two devices' errors at them lie apart (random weights
# have no outlier channels, so the alphas' errors lie close), and its
# linears are then not compared. A channel whose scale differs (beyond
# 1e-4: AWQ's s = m^alpha moves by float32 rounding with the captures) is a
# near-tie of the mse search when, on the card's own weights, the CPU's
# scale reconstructs the channel within 1e-3 of the card's error. Where the
# scales agree, at most 2 % of an AWQ linear's codes may differ, each by
# one step. GPTQ carries each row's rounding error into the rows after it,
# so one code that falls the other way moves the rest of its column: its
# codes are not compared one by one, but the layer objective each device's
# codes reach, ||X W - X Q(W)||^2 over the card's calibration inputs, must
# agree within 1 %.
LLM_CHECK_ERROR_RTOL, LLM_CHECK_SAME_SCALE_RTOL = 0.01, 1e-4
LLM_CHECK_SCALE_TIE, LLM_CHECK_AWQ_CODE_SHARE = 1e-3, 0.02
LLM_CHECK_GPTQ_OBJECTIVE_RTOL = 0.01


def _llm_cpu_reference_tree():
    """The 2-layer float tree of the card-versus-CPU check, and its
    calibration tokens, on the CPU."""
    from ppq_tpu_torch.serving import LlamaConfig, init_llama_params
    from ppq_tpu_torch.serving.model import quantize_weight
    cfg = LlamaConfig(**LLM_CHECK)
    fp = init_llama_params(cfg, seed=3, quantized=False, device='cpu')
    fp['lm_head'] = quantize_weight(fp['lm_head']['w'].float(), 8,
                                    device='cpu')
    calib = np.random.default_rng(5).integers(1, cfg.vocab_size, LLM_CALIB)
    return cfg, fp, calib


def _quantized_leaves(tree):
    """{layer/key: (codes int8, scale f32)} of every quantized linear of a
    tree, on the host (INT4 unpacked)."""
    from ppq_tpu_torch.serving.model import _unpack_int4
    out = {}
    for i, layer in enumerate(tree['layers']):
        for key, wq in layer.items():
            if isinstance(wq, dict) and 'scale' in wq:
                codes = wq['w_int'] if 'w_int' in wq else \
                    _unpack_int4(wq['w_packed'])
                out[f'{i}/{key}'] = (codes.cpu(), wq['scale'].float().cpu())
    return out


def _awq_with_alphas(fp, cfg, calib):
    """AWQ of a float tree and, per foldable group in order (each layer's
    attn, then mlp), the chosen alpha and every alpha's error."""
    from ppq_tpu_torch.serving import awq as awq_module
    record = []
    group_scale = awq_module._group_scale

    def recording(xs, weights, bits, alphas=(0.0, 0.25, 0.5, 0.75, 1.0),
                  max_rows=512, errors=None):
        errs = []
        s, a = group_scale(xs, weights, bits, alphas, max_rows, errors=errs)
        record.append((a, dict(errs)))
        return s, a

    awq_module._group_scale = recording
    try:
        tree = awq_module.awq_quantize_llama_params(fp, cfg, calib)
    finally:
        awq_module._group_scale = group_scale
    return tree, record


def main_llm_cpu_reference(out_path) -> int:
    """The CPU half of path M's card-versus-CPU check, run as a child
    process while the card works: AWQ and GPTQ of the 2-layer tree on the
    CPU, saved to out_path."""
    from ppq_tpu_torch.serving import gptq_quantize_llama_params
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    cfg, fp, calib = _llm_cpu_reference_tree()
    t0 = time.perf_counter()
    awq, alphas = _awq_with_alphas(fp, cfg, calib)
    awq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gptq = gptq_quantize_llama_params(fp, cfg, calib)
    gptq_s = time.perf_counter() - t0
    torch.save(dict(awq=_quantized_leaves(awq), gptq=_quantized_leaves(gptq),
                    awq_alphas=alphas, awq_s=awq_s, gptq_s=gptq_s),
               out_path + '.part')
    os.replace(out_path + '.part', out_path)
    return 0


CPU_REFERENCE_THREADS = 4


class _CpuReference:
    """The child process that computes the CPU half of a card-versus-CPU
    check (`mode`: path M's on CPU_REFERENCE_THREADS of the host's 8 cores,
    started before the serving paths (the full smoke) or with path M
    (`--llm`), so that it is done when path M needs it; path N's,
    `--api-cpu-reference`); `result()` waits for it. Killed if the smoke
    ends first."""

    def __init__(self, mode='--llm-cpu-reference'):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix='chip_smoke_ref_')
        self.path = os.path.join(self.dir, 'cpu_reference.pt')
        env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             mode, self.path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result(self, timeout=600):
        out, _ = self.proc.communicate(timeout=timeout)
        waited = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            raise AssertionError(f'the CPU reference failed:\n{out[-4000:]}')
        ref = torch.load(self.path)
        ref['wall_s_since_start'] = waited
        return ref

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)


def _llm_logits(params, cfg, tokens):
    """A prefill forward's logits (f32) over a (B, T) token batch on a fresh
    cache."""
    from ppq_tpu_torch.serving.model import forward, init_kv_cache
    B, T = tokens.shape
    dev = params['embed'].device
    with torch.no_grad():
        logits, _ = forward(
            params, init_kv_cache(cfg, B, device=dev),
            torch.as_tensor(tokens, dtype=torch.int32, device=dev),
            torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev), cfg)
    return logits


def _logit_snr(got, want) -> float:
    got, want = got.double(), want.double()
    return float(((got - want) ** 2).sum() / (want ** 2).sum())


def _llm_requests(vocab, n=LLM_REQUESTS, seed=31):
    from ppq_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(i, [int(t) for t in rng.integers(1, vocab, int(
        rng.integers(16, 100)))], max_new_tokens=LLM_NEW_TOKENS)
        for i in range(n)]


def _llm_engine(tag, cfg, params):
    """An engine served: `run` over a few requests, `benchmark_decode` at
    fill 16 (captured), and the launches of the two."""
    from ppq_tpu_torch.kernels import LAUNCHES
    from ppq_tpu_torch.serving import LlamaConfig, ServingEngine
    before = dict(LAUNCHES)
    engine = ServingEngine(LlamaConfig(**vars(cfg)), params)
    run = _serve_run(tag, engine, _llm_requests(cfg.vocab_size))
    decode = _decode_at(engine, 16)
    if decode['captures'] != 1:
        raise AssertionError(f'path M {tag}: benchmark_decode made '
                             f'{decode["captures"]} captures, not 1')
    counts = {k: LAUNCHES[k] - v for k, v in before.items()
              if LAUNCHES[k] != v}
    summary = dict(run=run, decode_fill_16=decode, launches=counts,
                   norm_folded=engine.cfg.norm_folded)
    del engine
    torch.cuda.empty_cache()
    return summary


def _llm_quantize(make):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = make()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return params, dict(seconds=time.perf_counter() - t0, peak_mem_gib=peak)


def _w8a8_sums(params, cfg, tokens):
    """The W8A8 prefill's int32 sums at full width (layer 0's q|k|v product
    over the calibration window) against an int64 reference (a float64
    product of the same codes: exact below 2^53)."""
    from ppq_tpu_torch.serving.model import _a8_quant, int8_product, rms_norm
    layer = params['layers'][0]
    dev = params['embed'].device
    x = params['embed'][torch.as_tensor(tokens, device=dev).long()]
    h = rms_norm(x, layer['attn_norm'], cfg.rms_eps)
    q, _ = _a8_quant(h)
    q = q.reshape(-1, q.shape[-1])
    w = layer['wq']['w_int']
    got = int8_product(q, w)
    want = torch.round(q.double() @ w.double()).long()
    if got.dtype != torch.int32 or not torch.equal(got.long(), want):
        raise AssertionError('path M: the W8A8 int32 sums differ from the '
                             'int64 reference')
    return dict(rows=q.shape[0], depth=q.shape[1], width=w.shape[1],
                max_abs_sum=int(want.abs().max()), equal=True)


def _moe_card_vs_cpu(params, cfg, dev):
    """One MoE layer's moe_ffn on the card against its plain CPU run on the
    same inputs (float32 einsums, TF32 off on the card)."""
    from ppq_tpu_torch.executor import simulation_precision
    from ppq_tpu_torch.serving.moe import moe_ffn
    moe = params['layers'][0]['moe']
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(
        4)).to(torch.bfloat16)
    with torch.no_grad(), simulation_precision('highest'):
        got = moe_ffn(x.to(dev), moe, top_k=cfg.top_k).float().cpu()
    cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in moe.items()}
    want = moe_ffn(x, cpu, top_k=cfg.top_k).float()
    err = float((got - want).abs().max())
    # bf16 outputs: one bf16 step of the largest |value| where the f32 sums'
    # order tips a rounding
    tol = 2 ** -7 * float(want.abs().max())
    if not err <= tol:
        raise AssertionError(f'path M: moe_ffn on the card vs the CPU: {err} '
                             f'> {tol}')
    return dict(max_abs_err=err, tolerance=tol)


def _speculative(dev, fp, cfg):
    """Target: the INT8 1B (round-to-nearest of the float tree); draft: a
    seeded 2-layer model at the same width. The tokens must be the
    target's plain greedy ones; acceptance and ms per token beside plain
    greedy, and the target as its own draft."""
    from ppq_tpu_torch.serving import (LlamaConfig, init_llama_params,
                                       quantize_llama_params,
                                       speculative_generate)
    from ppq_tpu_torch.serving.speculative import _Decoder
    tcfg = LlamaConfig(**dict(LLM, weight_bits=8))
    target = quantize_llama_params(fp, tcfg)
    dcfg = LlamaConfig(**dict(LLM, weight_bits=8,
                              n_layers=SPEC_DRAFT_LAYERS))
    draft = init_llama_params(dcfg, seed=1)
    prompt = [int(t) for t in np.random.default_rng(9).integers(
        1, cfg.vocab_size, 32)]

    def plain():
        dec = _Decoder(target, tcfg)
        out = [int(dec.run(prompt)[-1])]
        while len(out) < SPEC_TOKENS:
            out.append(int(dec.run([out[-1]])[-1]))
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / SPEC_TOKENS

    plain()                                   # warm the kernels
    ref, plain_ms = timed(plain)
    summary = dict(k=SPEC_K, tokens=SPEC_TOKENS, prompt=len(prompt),
                   plain_ms_per_token=plain_ms,
                   window_equals_steps=_window_vs_steps(target, tcfg,
                                                        prompt, ref))
    for name, dp, dc in (('draft_2_layers', draft, dcfg),
                         ('target_as_draft', target, tcfg)):
        (toks, stats), ms = timed(lambda: speculative_generate(
            target, tcfg, dp, dc, prompt, SPEC_TOKENS, k=SPEC_K))
        if toks != ref:
            first = next(i for i, (a, b) in enumerate(zip(toks, ref))
                         if a != b)
            raise AssertionError(f'path M: speculative tokens ({name}) leave '
                                 f'the plain greedy ones at {first}')
        summary[name] = dict(ms_per_token=ms, stats=stats,
                             acceptance=stats['accepted'] / stats['proposed'])
    if summary['target_as_draft']['acceptance'] != 1.0:
        raise AssertionError('path M: the target as its own draft was not '
                             'accepted throughout')
    del target, draft
    return summary


def _window_vs_steps(params, cfg, prompt, continuation):
    """What greedy speculation's exactness rests on: the logits of a
    (1, k+1) window over the dense cache (`batch_invariant`, as the
    decoders run) equal those of the same tokens as k+1 single steps, bit
    for bit."""
    import dataclasses
    from ppq_tpu_torch.serving.model import forward, init_kv_cache
    cfg = dataclasses.replace(cfg, use_kernel_matmul=True,
                              batch_invariant=True)
    dev = params['embed'].device

    def run(cache, toks, start):
        T = len(toks)
        with torch.no_grad():
            logits, _ = forward(
                params, cache,
                torch.tensor([toks], dtype=torch.int32, device=dev),
                (start + torch.arange(T, dtype=torch.int32,
                                      device=dev))[None],
                torch.tensor([start], dtype=torch.int32, device=dev),
                torch.tensor([start + T], dtype=torch.int32, device=dev),
                cfg)
        return logits[0]

    cache = init_kv_cache(cfg, 1, device=dev)
    run(cache, prompt, 0)
    window = continuation[:SPEC_K + 1]
    steps_cache = {k: v.clone() for k, v in cache.items()}
    whole = run(cache, window, len(prompt))
    single = torch.stack([run(steps_cache, [t], len(prompt) + i)[0]
                          for i, t in enumerate(window)])
    if not torch.equal(whole, single):
        diff = (whole - single).abs().amax(dim=-1).tolist()
        raise AssertionError(f'path M: a window of {len(window)} tokens and '
                             f'the same single steps differ (max |diff| a '
                             f'row {diff})')
    return True


def _scale_tie_gap(w, card_scale, cpu_scale, qmax):
    """Per channel, how much more the CPU's scale's reconstruction error
    is than the card's, relative, on the card's weights w (in, out)."""
    def err(sc):
        q = torch.clamp(torch.round(w / sc), -qmax - 1, qmax)
        return torch.mean((q * sc - w) ** 2, dim=0)
    e_card = err(card_scale)
    return (err(cpu_scale) - e_card) / e_card


def _effective_weights(fp, awq, key):
    """The weights an AWQ linear's scale was searched on, on the card: the
    groups' scaled by their s (= old gamma / folded gamma), wo and w_down
    as they are."""
    layer, name = key.split('/')
    w = fp['layers'][int(layer)][name]['w'].float()
    gamma = {'wq': 'attn_norm', 'wk': 'attn_norm', 'wv': 'attn_norm',
             'w_gate': 'mlp_norm', 'w_up': 'mlp_norm'}.get(name)
    if gamma is not None:
        s = fp['layers'][int(layer)][gamma].float() \
            / awq['layers'][int(layer)][gamma].float()
        w = w * s[:, None]
    return w


def _card_vs_cpu(reference):
    """AWQ and GPTQ of the 2-layer tree on the card against the CPU's."""
    from ppq_tpu_torch.serving import (LlamaConfig,
                                       gptq_quantize_llama_params,
                                       init_llama_params)
    from ppq_tpu_torch.executor import simulation_precision
    from ppq_tpu_torch.serving.awq import capture_norm_inputs
    from ppq_tpu_torch.serving.model import quantize_weight
    cfg = LlamaConfig(**LLM_CHECK)
    fp = init_llama_params(cfg, seed=3, quantized=False)
    fp['lm_head'] = quantize_weight(fp['lm_head']['w'].float(), 8)
    calib = np.random.default_rng(5).integers(1, cfg.vocab_size, LLM_CALIB)
    awq, alphas = _awq_with_alphas(fp, cfg, calib)
    caps = capture_norm_inputs(fp, cfg, calib, full=True)
    qmax = (1 << (cfg.weight_bits - 1)) - 1
    card = dict(awq=_quantized_leaves(awq),
                gptq=_quantized_leaves(gptq_quantize_llama_params(fp, cfg,
                                                                  calib)))
    t0 = time.perf_counter()
    ref = reference.result()
    summary = dict(cpu_awq_s=ref['awq_s'], cpu_gptq_s=ref['gptq_s'],
                   cpu_wall_s_since_start=ref['wall_s_since_start'],
                   waited_s=time.perf_counter() - t0)
    # AWQ groups whose alpha differs: a near-tie of the card's own errors,
    # or a failure; their linears are not compared
    skipped, ties = set(), []
    groups = [(i, g) for i in range(cfg.n_layers) for g in ('attn', 'mlp')]
    for (layer, group), (a, errs), (ra, rerrs) in zip(groups, alphas,
                                                      ref['awq_alphas']):
        apart = {x: abs(errs[x] - rerrs[x]) for x in errs}
        if any(apart[x] > LLM_CHECK_ERROR_RTOL * rerrs[x] for x in errs):
            raise AssertionError(f'path M awq layer {layer} {group}: errors '
                                 f'{errs} on the card, {rerrs} on the CPU')
        if a == ra:
            continue
        gap = abs(errs[a] - errs[ra])
        if gap > apart[a] + apart[ra]:
            raise AssertionError(f'path M awq layer {layer} {group}: alpha '
                                 f'{a} on the card, {ra} on the CPU, errors '
                                 f'{errs} and {rerrs}')
        ties.append(dict(layer=layer, group=group, card=a, cpu=ra,
                         gap=gap / errs[a]))
        keys = ('wq', 'wk', 'wv') if group == 'attn' else ('w_gate', 'w_up')
        skipped.update(f'{layer}/{k}' for k in keys)
    summary['awq_alpha_ties'] = ties
    worst_codes = worst_scales = worst_gap = 0.0
    compared = 0
    for key, (codes, scale) in card['awq'].items():
        if key in skipped:
            continue
        rcodes, rscale = ref['awq'][key]
        same = torch.isclose(scale, rscale, rtol=LLM_CHECK_SAME_SCALE_RTOL,
                             atol=0)
        if not same.all():
            dev = fp['embed'].device
            w = _effective_weights(fp, awq, key)[:, (~same).to(dev)]
            gap = float(_scale_tie_gap(w, scale[~same].to(dev),
                                       rscale[~same].to(dev), qmax).max())
            if gap > LLM_CHECK_SCALE_TIE:
                raise AssertionError(
                    f'path M awq {key}: the CPU\'s scale of a channel '
                    f'reconstructs it {gap} worse on the card')
            worst_gap = max(worst_gap, gap)
        differ = (codes != rcodes)[:, same]
        share_c = float(differ.float().mean()) if differ.numel() else 0.0
        steps = (codes.int() - rcodes.int()).abs()[:, same]
        if share_c > LLM_CHECK_AWQ_CODE_SHARE or \
                (steps.numel() and int(steps.max()) > 1):
            raise AssertionError(
                f'path M awq {key}: card vs CPU codes differ on {share_c} '
                f'of the channels with equal scales, by up to '
                f'{int(steps.max())}')
        worst_codes = max(worst_codes, share_c)
        worst_scales = max(worst_scales, float((~same).float().mean()))
        compared += 1
    summary['awq'] = dict(linears=compared, worst_code_share=worst_codes,
                          worst_scale_share=worst_scales,
                          worst_scale_tie_gap=worst_gap)
    # GPTQ: the objective each device's codes reach on the card's inputs
    inputs = {'wq': 'attn', 'wk': 'attn', 'wv': 'attn', 'wo': 'ctx',
              'w_gate': 'mlp', 'w_up': 'mlp', 'w_down': 'act'}
    worst, shares = 0.0, []
    with simulation_precision('highest'):
        for key, (codes, scale) in card['gptq'].items():
            layer, name = key.split('/')
            xs = caps[int(layer)][inputs[name]]
            w = fp['layers'][int(layer)][name]['w'].float()
            ref_out = xs @ w

            def objective(c, sc):
                deq = c.to(xs.device).float() * sc.to(xs.device)
                return float(torch.mean((ref_out - xs @ deq) ** 2))

            rcodes, rscale = ref['gptq'][key]
            mine, theirs = objective(codes, scale), objective(rcodes, rscale)
            rel = abs(mine - theirs) / mine
            if rel > LLM_CHECK_GPTQ_OBJECTIVE_RTOL:
                raise AssertionError(f'path M gptq {key}: objective {mine} '
                                     f'on the card, {theirs} with the '
                                     f'CPU\'s codes')
            worst = max(worst, rel)
            shares.append(float((codes != rcodes).float().mean()))
    summary['gptq'] = dict(linears=len(shares), worst_objective_rel=worst,
                           code_share_max=max(shares),
                           code_share_mean=sum(shares) / len(shares))
    return summary


def phase_path_m(dev, reference):
    """Path M: the LLM quantization path at the 1B decoder's full width.
    `reference`: the _CpuReference, started just before."""
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.serving import (LlamaConfig, awq_quantize_llama_params,
                                       gptq_quantize_llama_params,
                                       init_llama_params,
                                       quantize_llama_params,
                                       smoothquant_llama_params)
    torch.cuda.empty_cache()
    reset_launches()
    t_path = time.perf_counter()
    stages = {}

    def stage(name):
        stages[name] = time.perf_counter() - t_path
        log(f'[path M] {name} done at {stages[name]:.1f} s')

    cfg = LlamaConfig(**LLM)
    cfg4 = LlamaConfig(**dict(LLM, weight_bits=4))
    cfg_a8 = LlamaConfig(**dict(LLM, weight_bits=8, act_bits=8))
    t0 = time.perf_counter()
    fp = init_llama_params(cfg, seed=0, quantized=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    calib = rng.integers(1, cfg.vocab_size, LLM_CALIB)
    evalt = rng.integers(1, cfg.vocab_size, LLM_EVAL)
    ref_logits = _llm_logits(fp, cfg, evalt)

    quantizers = dict(
        awq_int4=(cfg4, lambda: awq_quantize_llama_params(fp, cfg4, calib)),
        gptq_int4=(cfg4, lambda: gptq_quantize_llama_params(fp, cfg4,
                                                            calib)),
        rtn_int4=(cfg4, lambda: quantize_llama_params(fp, cfg4)),
        rtn_int4_mse=(cfg4, lambda: quantize_llama_params(fp, cfg4,
                                                          method='mse')),
        smoothquant_w8a8=(cfg_a8, lambda: smoothquant_llama_params(
            fp, cfg_a8, calib)),
        rtn_w8a8=(cfg_a8, lambda: quantize_llama_params(fp, cfg_a8)),
    )
    methods, kept = {}, {}
    for name, (qcfg, make) in quantizers.items():
        params, stats = _llm_quantize(make)
        stats['logits_snr'] = _logit_snr(_llm_logits(params, qcfg, evalt),
                                         ref_logits)
        methods[name] = stats
        log(f'[path M] {name}: {json.dumps(stats)}')
        if name in ('awq_int4', 'gptq_int4', 'smoothquant_w8a8'):
            kept[name] = (qcfg, params)
        del params
    for name in ('awq_int4', 'gptq_int4'):
        if not methods[name]['logits_snr'] < 1.0:
            raise AssertionError(f'path M {name}: logits SNR '
                                 f'{methods[name]["logits_snr"]}')
    stage('quantizers')
    w8a8_sums = _w8a8_sums(kept['smoothquant_w8a8'][1], cfg_a8, calib)
    engines = {}
    for name, (qcfg, params) in kept.items():
        engines[name] = _llm_engine(name, qcfg, params)
        log(f'[path M] engine {name}: {json.dumps(engines[name])}')
        counts = engines[name]['launches']
        if qcfg.act_bits == 8:
            if counts.get('qmm_gateup', 0) or \
                    counts.get('qmm_gateup_int4', 0) or \
                    not counts.get('qmm_int8', 0):
                raise AssertionError(f'path M {name}: W8A8 decode launched '
                                     f'{counts}: row 8 only, no row 10')
        elif not (counts.get('qmm_int4', 0) and
                  counts.get('qmm_gateup_int4', 0)):
            raise AssertionError(f'path M {name}: INT4 decode launched '
                                 f'{counts}: rows 9 and 10 expected')
    del kept
    stage('engines')

    # MoE at the same widths, 8 experts top-2, 2 layers
    moe_cfg = LlamaConfig(**LLM_MOE)
    t0 = time.perf_counter()
    moe_params = init_llama_params(moe_cfg, seed=0)
    torch.cuda.synchronize()
    moe_build_s = time.perf_counter() - t0
    moe = _llm_engine('moe', moe_cfg, moe_params)
    if moe['norm_folded'] or moe['launches'].get('qmm_gateup', 0):
        raise AssertionError(f'path M moe: {moe}')
    moe['build_s'] = moe_build_s
    launches = dict(LAUNCHES)
    stage('moe')

    # ---- comparisons: these launches are not the path's -----------------
    moe['card_vs_cpu'] = _moe_card_vs_cpu(moe_params, moe_cfg, dev)
    log(f'[path M] moe: {json.dumps(moe)}')
    del moe_params
    torch.cuda.empty_cache()
    stage('moe_card_vs_cpu')
    spec = _speculative(dev, fp, cfg)
    log(f'[path M] speculative: {json.dumps(spec)}')
    del fp
    torch.cuda.empty_cache()
    stage('speculative')
    check = _card_vs_cpu(reference)
    log(f'[path M] awq / gptq card vs cpu: {json.dumps(check)}')
    stage('awq_gptq_card_vs_cpu')
    summary = dict(model=LLM, stages_s=stages, float_build_s=build_s,
                   quantizers=methods,
                   w8a8_int32_sums=w8a8_sums, engines=engines, moe=moe,
                   moe_model=LLM_MOE, speculative=spec,
                   awq_gptq_card_vs_cpu=check)
    log(f'[path M] {json.dumps(summary)}')
    return launches, summary


def main_llm() -> int:
    """Path M alone: the LLM quantization path at full width."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build(['qmm', 'kv_write', 'paged_attention'])
    reference = _CpuReference()
    try:
        launches, _ = phase_path_m(dev, reference)
    finally:
        reference.close()
    log(f'[launches] path M {json.dumps(launches)}')
    _check_path_kernels('M', launches)
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------- path O ----
# The parallel layer: four ranks share the one card (gloo; every collective
# staged through host memory), spawned by ppq_tpu_torch.parallel.spawn.
PAR_WORLD = 4
PAR_CALIB_STEPS = 4
# lr: the largest of 1e-5, 1e-6, 1e-7 whose three steps lower the loss
# (1e-5 raised it 17-fold at step 2: Adam moves all 11.7 M weights at once)
PAR_TRAIN_STEPS, PAR_LR = 3, 1e-6
PAR_RING = dict(tokens=4096, heads=16, head_dim=128)
PAR_PIPE = dict(batch=8, tokens=64, microbatches=4)
PAR_REQUESTS, PAR_NEW_TOKENS, PAR_DECODE_STEPS = 32, 16, 8
# bench.py's 1B decoder at path M's 32 slots; blocks of 256 for the paged
# engine
PAR_SERVE = dict(SERVE, max_batch=32)
PAR_VARIANTS = {
    'int8_dense': dict(use_ragged_attention=False),
    'int8_ragged': dict(),
    'int8_paged': dict(paged_kv=True, kv_block_size=256),
    'int4_ragged': dict(weight_bits=4),
}
# O8-O13: the pipeline and sequence meshes of the same engine (INT8, the
# ragged read, blocks of 256 where paged): tag -> (name, fields, mesh axes,
# first rank). Two-rank legs run two at a time on the rank pairs. The paged
# legs' pool holds 97 blocks, what benchmark_decode at fill 512 takes (32
# slots of 3 blocks and the trash row): its 'sp' shards split at block 49
# (dp 2 x sp 2: at 25 in each dp row), inside the run's blocks. Their
# prompts of up to 512 tokens admit in one batched prefill (chunks of 128,
# one a prompt and 16 collectives a layer, took O11's run 28 s of 17)
PAR_MESH_PAGED = dict(paged_kv=True, kv_block_size=256, kv_pool_blocks=97,
                      prefill_buckets=(512,))
PAR_MESH_LEGS = {
    'O8': ('pp2_dense', {}, (('pp', 2),), 0),
    'O9': ('sp2_dense', {}, (('sp', 2),), 2),
    'O10': ('pp2_paged', PAR_MESH_PAGED, (('pp', 2),), 0),
    'O11': ('sp2tp2_paged', PAR_MESH_PAGED, (('sp', 2), ('tp', 2)), 0),
    'O12': ('dp2sp2_paged', dict(PAR_MESH_PAGED, prefix_cache_blocks=64),
            (('dp', 2), ('sp', 2)), 0),
    'O13': ('pp2sp2_paged', PAR_MESH_PAGED, (('pp', 2), ('sp', 2)), 0),
}
# their requests' prompt lengths: the dense legs' long prompt crosses
# position 512, where a two-way sequence shard splits max_seq_len 1024 (a
# dense chunk runs every slot's row: one long prompt); the paged legs'
# 18 take 2-3 blocks of 256 (the 600-token one in chunks, the rest in one
# prefill), the 505-510-token ones a third block in the run's first burst
# of 8, which the second reads, so that the allocator's rows pass every
# shard's boundary and slots read blocks of two shards (`spans`; at sp 2
# from the second burst on). 16 new tokens each, in bursts of 8;
# benchmark_decode 4 steps a burst. O12 then repeats the second prompt,
# whose first two blocks its dp row's prefix cache holds
PAR_MESH_DENSE_LENGTHS = (600, 40, 90, 70)
PAR_MESH_PAGED_LENGTHS = (300, 600) + (505, 508, 510, 506) * 4
PAR_MESH_NEW_TOKENS, PAR_MESH_SYNC, PAR_MESH_DECODE_STEPS = 16, 8, 4
# The sharded step against one card's on the same global batch, walked in
# the dp shards' halves (loss and gradients summed half by half: the
# ranks' sums in their order): the same bits; 1e-6 relative and 1e-9 are
# the bounds. Against one card's walk of all 32 at once the halves' cuDNN
# algorithms differ (sum order), a code at a rounding tie flips and the
# trajectories part: the losses held within 5 % (1.65 % measured), the
# weights' distance reported only (Adam moves an element about lr a step
# whatever its gradient's size, so no bound on it could fail). Adam does
# not see a gradient's scale either, so the first step's all-reduced
# gradients are held against one card's: their distance over the norm of
# one card's, every weight at once, within 1e-6 of the halves' walk and 5 %
# of the whole batch's (set before the first reading; 4.27 % measured, the
# same cuDNN parting); a dp reduction that summed where it should average
# would read 1.0
PAR_LOSS_RTOL, PAR_PARAM_ATOL = 1e-6, 1e-9
PAR_WHOLE_LOSS_RTOL = 0.05
PAR_GRAD_RTOL = 0.05
# ring attention against reference_attention: both sum in float32 and round
# to bf16, in other orders: two bf16 steps of the largest |output|
PAR_RING_TOL = 2 ** -7
# O4, the pipeline against the flat walk of the same microbatches through
# the 16 layers on one card: the same products on the same rows (a walk of
# the whole batch at once would cross the matmul kernels' row cap, which
# changes w_down's product: recorded difference 12, 0.022 of the largest
# activation after 16 layers); bound one bf16 step of the largest
# |activation|
PAR_PIPE_TOL = 2 ** -8
# O1's scales against one card's: the reductions are exact (min / max,
# int64 histograms, the union of the ranks' top-k candidates holds the
# whole batch's order statistics: bit for bit on the CPU), but on the card
# a rank's convolutions at its dp shard's batch of 16 take other cuDNN
# algorithms than one card's at 32, so the activations, and with them the
# abs-max, the quantiles and a KL bin's width, move by float32 rounding
# (measured 4.9e-7 percentile, 8.4e-7 KL). 2e-6 is a few float32 steps;
# a KL threshold one bin of 2048 away moves its scale by 2.4e-4
PAR_CALIB_RTOL = 2e-6
PATH_KERNELS['O'] = ('fake_quant_tensorwise', 'fake_quant_channelwise',
                     'histogram', 'fake_quant_bwd_tensorwise',
                     'fake_quant_bwd_channelwise', 'qmm_int8', 'qmm_int4',
                     'qmm_gateup', 'qmm_gateup_int4', 'paged_attention_fused',
                     'paged_attention_grouped', 'bank_write', 'window_write',
                     'pool_write')
# what O1-O2 and O5-O6 must launch (rows 1-5; rows 8-12 and 14-16)
PAR_QUANT_ROWS = PATH_KERNELS['O'][:5]
PAR_SERVE_ROWS = PATH_KERNELS['O'][5:]
# what each of O8-O13 must launch on every rank of its mesh: rows 8 and 10,
# the reads (row 11 or 12), row 14, and row 15 (dense) or 16 (paged)
PAR_MESH_ROWS = ('qmm_int8', 'qmm_gateup', 'bank_write')
PAR_READ_ROWS = ('paged_attention_fused', 'paged_attention_grouped')
# the sizes path O runs at (a CPU rehearsal passes smaller ones)
PAR_PLAN = dict(image=[CALIB_BATCH, 3, IMAGE, IMAGE],
                calib_steps=PAR_CALIB_STEPS, ring=PAR_RING, pipe=PAR_PIPE,
                serve=PAR_SERVE, moe=LLM_MOE, requests=PAR_REQUESTS,
                moe_requests=LLM_REQUESTS, new_tokens=PAR_NEW_TOKENS,
                moe_new_tokens=LLM_NEW_TOKENS, fills=(16, 512),
                mesh_legs=PAR_MESH_LEGS, mesh_paged=PAR_MESH_PAGED,
                mesh_dense_lengths=PAR_MESH_DENSE_LENGTHS,
                mesh_paged_lengths=PAR_MESH_PAGED_LENGTHS,
                mesh_new_tokens=PAR_MESH_NEW_TOKENS, mesh_sync=PAR_MESH_SYNC,
                mesh_decode_steps=PAR_MESH_DECODE_STEPS)


def _sync(dev):
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize()


def _o_llama_params(cfg, seed, dev):
    """init_llama_params' tree for `cfg`, its float weights drawn on the
    card from a seeded generator: every rank and the one-card reference
    draw the same weights (the numpy draw of the 1B model takes ~17 s a
    process), then each matrix is quantized as init_llama_params does."""
    from ppq_tpu_torch.serving.model import quantize_weight
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, H, KV, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)

    def draw(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def dense(i, o, bits=cfg.weight_bits):
        return quantize_weight(draw((i, o), 1.0 / np.sqrt(i)), bits,
                               device=dev)

    def stack(i, o):
        # init_moe_params' quantization: scales per (expert, out-channel)
        w = draw((cfg.n_experts, i, o), 1.0 / np.sqrt(i))
        qmax = (1 << (cfg.weight_bits - 1)) - 1
        scale = w.abs().amax(dim=1).clamp_min(1e-8) / torch.tensor(
            float(qmax), device=dev)
        q = torch.round(w / scale[:, None, :]).clamp(-qmax - 1, qmax)
        return {'w_int': q.to(torch.int8), 'scale': scale}

    ones = torch.ones((D,), dtype=torch.float32, device=dev)
    params = {'embed': draw((cfg.vocab_size, D), 0.02).to(torch.bfloat16),
              'final_norm': ones.clone(),
              'lm_head': dense(D, cfg.vocab_size, cfg.resolved_lm_head_bits),
              'layers': []}
    for _ in range(cfg.n_layers):
        layer = {'attn_norm': ones.clone(), 'mlp_norm': ones.clone(),
                 'wq': dense(D, H * Dh), 'wk': dense(D, KV * Dh),
                 'wv': dense(D, KV * Dh), 'wo': dense(H * Dh, D)}
        if cfg.n_experts:
            layer['moe'] = {'router': draw((D, cfg.n_experts), 0.02),
                            'w_gate': stack(D, F), 'w_up': stack(D, F),
                            'w_down': stack(F, D)}
        else:
            layer.update(w_gate=dense(D, F), w_up=dense(D, F),
                         w_down=dense(F, D))
        params['layers'].append(layer)
    return params


def _o_requests(vocab, n, new, seed=41):
    """n seeded requests of 16-99 prompt tokens and `new` new tokens (seed
    31: path M's prompts)."""
    from ppq_tpu_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(i, [int(t) for t in rng.integers(1, vocab, int(
        rng.integers(16, 100)))], max_new_tokens=new) for i in range(n)]


def _o_calibration_graph(method, shape):
    """The zoo ResNet-18 at `shape`, dispatched and quantized for TPU_INT8
    with every activation awaiting `method`'s calibration (the compiled
    calibration pass's input, tests/test_parallel_calibration.py's recipe)."""
    from ppq_tpu_torch import TargetPlatform, dispatch_graph
    from ppq_tpu_torch.ir import QuantableOperation, format_graph
    from ppq_tpu_torch.quantization.optim import ParameterQuantizePass
    from ppq_tpu_torch.quantization.quantizer import TPUInt8Quantizer
    from ppq_tpu_torch.zoo import resnet18
    g = format_graph(resnet18(input_shape=shape))
    dispatch_graph(g, TargetPlatform.TPU_INT8)
    q = TPUInt8Quantizer(g)
    for name, op in list(g.operations.items()):
        if op.platform == q.target_platform and \
                op.type in q.quant_operation_types:
            q.quantize_operation(name)
    ParameterQuantizePass().optimize(g)
    for op in g.operations.values():
        if isinstance(op, QuantableOperation):
            for var, cfg in op.config_pairs():
                if not var.is_parameter:
                    cfg.observer_algorithm = method
    return g


def _o_calibrate(plan, dev, mesh=None):
    """O1: percentile and KL over the plan's batches (4 of 32 at 224²):
    {method: (graph, scales, seconds)}."""
    import types
    from ppq_tpu_torch.quantization.optim import CompiledCalibrationPass
    shape = plan['image']
    rng = np.random.RandomState(0)          # _data()'s first batches
    loader = [rng.randn(*shape).astype(np.float32)
              for _ in range(plan['calib_steps'])]
    out = {}
    for method in ('percentile', 'kl'):
        g = _o_calibration_graph(method, shape)
        _sync(dev)
        t0 = time.perf_counter()
        CompiledCalibrationPass(calib_steps=plan['calib_steps'], mesh=mesh) \
            .optimize(g, dataloader=loader,
                      executor=types.SimpleNamespace(device=dev))
        _sync(dev)
        out[method] = (g, _activation_scales(g), time.perf_counter() - t0)
    return out


def _o_train_batch(plan, dev):
    """O2's global batch (seeded) and its target, the seeded model's fp32
    outputs: (numpy batch, target tensor on `dev`)."""
    from ppq_tpu_torch import TorchExecutor
    from ppq_tpu_torch.zoo import resnet18
    x = np.random.RandomState(1).randn(*plan['image']).astype(np.float32)
    target = TorchExecutor(resnet18(input_shape=plan['image']),
                           device=dev).forward(x)[0].detach()
    return x, target


def _o_train(plan, graph, mesh, dev):
    """O2: the sharded step on the KL graph, PAR_TRAIN_STEPS steps on one
    seeded global batch (32 at 224²) towards the fp32 model's outputs:
    (losses, full parameters, seconds a step, the first step's all-reduced
    gradients: this rank's slices of the tp-sharded weights)."""
    import copy
    from ppq_tpu_torch.executor.compile import CompiledGraph
    from ppq_tpu_torch.parallel import make_sharded_train_step, shard_batch
    from ppq_tpu_torch.quantization.optim.training import _unbaked_parameters
    graph = copy.deepcopy(graph)
    x, target = _o_train_batch(plan, dev)
    with _unbaked_parameters(graph):
        cg = CompiledGraph(graph, device=dev)
        step, state = make_sharded_train_step(cg, mesh, lr=PAR_LR)
        xs = shard_batch(mesh, x, dev)
        ts = shard_batch(mesh, target.cpu(), dev)
        losses, times, grads = [], [], None
        for _ in range(PAR_TRAIN_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            state, loss = step(state, xs, ts)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            if grads is None:
                grads = {k: v.grad.detach().cpu() for k, v in
                         state['trainable']['params'].items()}
        full = {k: v.detach().cpu() for k, v in step.full_params().items()}
    return losses, full, times, grads


def _o_grad_apart(local, full, coords):
    """A rank's first-step gradients against one card's: the distance over
    the norm of one card's, every weight at once, one card's sliced as the
    rank holds it (tp_param_shardings on the 2 x 2 mesh)."""
    from ppq_tpu_torch.parallel.mesh import _tp_axis_for, local_slice
    num = den = 0.0
    for k, g in full.items():
        ax = _tp_axis_for(k, tuple(g.shape), 2)
        if ax is not None:
            g = local_slice(g, tuple('tp' if i == ax else None
                                     for i in range(g.dim())),
                            {'dp': 2, 'tp': 2}, coords)
        num += float((local[k].double() - g.double()).pow(2).sum())
        den += float(g.double().pow(2).sum())
    return (num / den) ** 0.5


def _o_train_in_halves(plan, graph, dev, parts=2):
    """O2's one-card reference: the sharded step's arithmetic on one card,
    the global batch walked in the dp shards' `parts` halves, each half's
    loss and gradients summed in the ranks' order, then Adam (optax's
    defaults). Returns (losses, parameters, the first step's gradients)."""
    import copy
    from ppq_tpu_torch.executor.compile import CompiledGraph
    from ppq_tpu_torch.executor.ops.default import simulation_precision
    from ppq_tpu_torch.quantization.optim.training import _unbaked_parameters
    graph = copy.deepcopy(graph)
    x, target = _o_train_batch(plan, dev)
    name = list(graph.inputs)[0]
    with _unbaked_parameters(graph):
        cg = CompiledGraph(graph, device=dev)
        fwd = cg.build_trainable_forward()
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in cg.init_params().items()}
        q = {k: {kk: vv.detach().clone().requires_grad_(True)
                 for kk, vv in v.items()} for k, v in cg.init_qparams().items()}
        tensors = list(params.values()) + [t for pair in q.values()
                                           for t in pair.values()]
        opt = torch.optim.Adam(tensors, lr=PAR_LR, betas=(0.9, 0.999),
                               eps=1e-8)
        xs = torch.from_numpy(x).to(dev).chunk(parts)
        ts = target.chunk(parts)
        losses, grads = [], None
        for _ in range(PAR_TRAIN_STEPS):
            opt.zero_grad(set_to_none=True)
            total = None
            for xh, th in zip(xs, ts):
                out = fwd(params, q, {name: xh})[0].to(torch.float32)
                loss = torch.sum((out - th) ** 2) / target.numel()
                with simulation_precision():
                    loss.backward()
                total = loss.detach() if total is None \
                    else total + loss.detach()
            if grads is None:
                grads = {k: v.grad.detach().cpu().clone()
                         for k, v in params.items()}
            opt.step()
            losses.append(float(total))
    return losses, {k: v.detach().cpu() for k, v in params.items()}, grads


def _o_qkv(plan, dev):
    gen = torch.Generator(device=dev).manual_seed(23)
    ring = plan['ring']
    shape = (1, ring['tokens'], ring['heads'], ring['head_dim'])
    return [torch.randn(shape, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(3)]


def _o_block(cfg):
    """One decoder layer without a cache (the GPipe block of O4): pre-norm
    causal attention over the microbatch's own tokens (GQA heads expanded)
    and the MLP, through the serving model's products and kernels."""
    from ppq_tpu_torch.serving.model import (mlp, project_qkv, qmatmul,
                                             rms_norm, rope)
    from ppq_tpu_torch.serving.ring_attention import reference_attention
    rep = cfg.n_heads // cfg.n_kv_heads

    def block(layer, x):
        B, T, D = x.shape
        pos = torch.arange(T, dtype=torch.int32, device=x.device)[None] \
            .expand(B, T)
        h = rms_norm(x, layer['attn_norm'], cfg.rms_eps)
        q, k, v = project_qkv(h, layer, cfg, True)
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        ctx = reference_attention(q, k.repeat_interleave(rep, dim=2),
                                  v.repeat_interleave(rep, dim=2))
        x = x + qmatmul(ctx.reshape(B, T, D).to(x.dtype), layer['wo'],
                        kernel=True)
        return x + mlp(rms_norm(x, layer['mlp_norm'], cfg.rms_eps), layer,
                       cfg)
    return block


def _o_pipe_input(plan, params, dev):
    gen = torch.Generator(device=dev).manual_seed(29)
    pipe = plan['pipe']
    tokens = torch.randint(1, plan['serve']['vocab_size'],
                           (pipe['batch'], pipe['tokens']),
                           generator=gen, device=dev)
    return params['embed'][tokens]


def _o_probe(engine, reqs):
    """The engine's logits after the first prompt: one forward over a fresh
    one-slot cache of the rank's shape (its slices of the global cache:
    its kv heads, its stage's layers, its positions), staged on a 'pp'
    mesh."""
    from ppq_tpu_torch.serving.model import forward, init_kv_cache
    from ppq_tpu_torch.serving.pipeline import forward_staged
    from ppq_tpu_torch.serving.tensor_parallel import rank_cache
    seq = reqs[0].prompt
    T, dev = len(seq), engine.device
    cache = init_kv_cache(engine.cfg, 1, dev) if engine.mesh is None else \
        rank_cache(engine._model_cfg, engine.mesh, 1, dev)
    args = (engine.params, cache,
            torch.tensor([seq], dtype=torch.int32, device=dev),
            torch.arange(T, dtype=torch.int32, device=dev)[None],
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), T, dtype=torch.int32, device=dev), engine.cfg)
    with torch.no_grad():
        if engine._pp:
            logits, _ = forward_staged(*args, engine.mesh, microbatches=1)
        else:
            logits, _ = forward(*args, sp_mesh=engine._sp_mesh)
    return logits[0, -1].float().cpu()


def _o_block_spans(engine):
    """The most pool shards one slot's blocks lie on, over every paged burst
    of the engine's runs (1 where the block axis is not sharded)."""
    from ppq_tpu_torch.serving.paged import block_shard
    spans = [1]
    shard = block_shard(engine.cache, engine.mesh) if engine._paged and \
        engine.mesh is not None else None
    if shard is not None:
        real = engine._paged_decode

        def watch(n, *a, **k):
            for row in engine._alloc.tables():
                spans.append(len({int(b) // shard.size for b in row if b}))
            return real(n, *a, **k)
        engine._paged_decode = watch
    return spans


def _o_serve(cfg, params, mesh, reqs, fills, dev, repeat=False,
             sync=SERVE_SYNC, steps=PAR_DECODE_STEPS):
    """An engine on `mesh` (None: one card): `run` over the requests, in
    bursts of `sync`, and benchmark_decode for `steps` steps at each fill.
    Returns its
    tokens, probe logits, seconds, ms a step, the kernels it launched (a
    one-card burst's replays count what they launch), the device's fault
    bits, the collectives a decode step (count, host seconds, bytes), and
    on a block-sharded pool the most shards one slot's blocks lay on.
    repeat: a second `run` of the second prompt after the first run (it
    lands on slot 0, on a dp-grouped pool in that prompt's dp row; on a
    prefix-cached engine its blocks are adopted), its tokens and the prefix
    cache's hits and misses."""
    from ppq_tpu_torch.kernels import LAUNCHES, read_faults
    from ppq_tpu_torch.parallel import multihost
    from ppq_tpu_torch.serving import Request, ServingEngine
    before = dict(LAUNCHES)
    cuda = torch.device(dev).type == 'cuda'
    if cuda:
        read_faults(dev)
    engine = ServingEngine(cfg, params, mesh=mesh, device=dev)
    spans = _o_block_spans(engine)
    _sync(dev)
    t0 = time.perf_counter()
    engine.run(reqs, sync_every=sync)
    _sync(dev)
    out = dict(tokens=[list(r.generated) for r in reqs],
               prompts=[list(r.prompt) for r in reqs],
               run_s=time.perf_counter() - t0,
               logits=_o_probe(engine, reqs), decode={}, collectives={})
    if not all(r.done and len(r.generated) == r.max_new_tokens
               for r in reqs):
        raise AssertionError(f'path O: a request did not finish ({cfg})')
    if repeat:
        # outside the counts: one card repeats without a prefix cache
        held = dict(LAUNCHES)
        again = [Request(len(reqs), list(reqs[1].prompt),
                         max_new_tokens=reqs[1].max_new_tokens)]
        engine.run(again, sync_every=sync)
        LAUNCHES.update(held)
        out['repeat'] = dict(prompt=again[0].prompt,
                             tokens=list(again[0].generated))
        if engine.prefix_cache is not None:
            out['repeat'].update(hits=engine.prefix_cache.hits,
                                 misses=engine.prefix_cache.misses,
                                 cache=type(engine.prefix_cache).__name__)
    at_decode = dict(LAUNCHES)
    for fill in fills:
        multihost.reset_transport()
        d = engine.benchmark_decode(steps=steps, burst=steps, fill=fill,
                                    repeats=1)
        out['decode'][f'fill_{fill}'] = d['ms_per_step']
        # a warm burst and one timed burst of `steps` steps
        ran = 2 * steps
        out['collectives'][f'fill_{fill}'] = dict(
            calls=sum(multihost.TRANSPORT_COUNTS.values()) / ran,
            host_s=sum(multihost.TRANSPORT_SECONDS.values()) / ran,
            bytes=sum(multihost.TRANSPORT_BYTES.values()) / ran)
    out['launches'] = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                       if v != before.get(k, 0)}
    out['decode_launches'] = {k: v - at_decode.get(k, 0)
                              for k, v in LAUNCHES.items()
                              if v != at_decode.get(k, 0)}
    out['faults'] = read_faults(dev) if cuda else []
    out['spans'] = max(spans)
    del engine
    _empty(dev)
    return out


def _empty(dev):
    if torch.device(dev).type == 'cuda':
        torch.cuda.empty_cache()


def _o_variant(plan, name):
    from ppq_tpu_torch.serving import LlamaConfig
    return LlamaConfig(**dict(plan['serve'], **PAR_VARIANTS[name]))


def _o_serve_requests(plan, cfg):
    return _o_requests(cfg.vocab_size, plan['requests'], plan['new_tokens'])


def _o_moe_requests(plan, cfg):
    return _o_requests(cfg.vocab_size, plan['moe_requests'],
                       plan['moe_new_tokens'], seed=31)


def _o_mesh_config(plan, tag):
    from ppq_tpu_torch.serving import LlamaConfig
    return LlamaConfig(**dict(plan['serve'], **plan['mesh_legs'][tag][1]))


def _o_mesh_requests(plan, cfg):
    """O8-O13's requests: seeded prompts of the plan's lengths (the paged
    legs' or the dense legs'), each with mesh_new_tokens new tokens."""
    from ppq_tpu_torch.serving import Request
    rng = np.random.default_rng(43)
    lengths = plan['mesh_paged_lengths'] if cfg.paged_kv else \
        plan['mesh_dense_lengths']
    return [Request(i, [int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=plan['mesh_new_tokens'])
            for i, n in enumerate(lengths)]


def _path_o_rank(o1_graph, plan):
    """Path O on one rank of the world (every rank runs it). `o1_graph`:
    the one-card KL graph, the sharded step's starting point; `plan`: the
    sizes (PAR_PLAN). Returns the rank's results, its launches by step and
    the backend and transport it used."""
    from ppq_tpu_torch.kernels import LAUNCHES, reset_launches
    from ppq_tpu_torch.parallel import make_mesh, multihost
    from ppq_tpu_torch.parallel.mesh import Mesh
    from ppq_tpu_torch.serving import LlamaConfig
    from ppq_tpu_torch.serving.pipeline import (pipeline_forward,
                                                stack_layer_params)
    from ppq_tpu_torch.serving.ring_attention import \
        sequence_parallel_attention
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = multihost.world_device()
    rank = multihost.global_rank()
    out = dict(rank=rank, backend=multihost.world_backend(),
               transport_kind=multihost.world_transport(), seconds={},
               launches={}, transport={})
    t_path = time.perf_counter()

    def run(name, fn):
        reset_launches()
        multihost.reset_transport()
        _sync(dev)
        t0 = time.perf_counter()
        result = fn()
        _sync(dev)
        out['seconds'][name] = time.perf_counter() - t0
        out['launches'][name] = {k: v for k, v in LAUNCHES.items() if v}
        out['transport'][name] = dict(
            calls=dict(multihost.TRANSPORT_COUNTS),
            seconds=dict(multihost.TRANSPORT_SECONDS),
            bytes=dict(multihost.TRANSPORT_BYTES))
        multihost.sync_global_devices()     # the next step starts together
        return result

    # every rank builds every mesh (their groups are made collectively)
    mesh22 = make_mesh(dp=2, tp=2)
    sp = {n: Mesh(np.arange(n), ('sp',)) for n in (2, 4)}
    pp2 = Mesh(np.arange(2), ('pp',))
    tp2 = Mesh(np.arange(2).reshape(1, 2), ('dp', 'tp'))
    ep2 = Mesh(np.arange(2), ('ep',))
    legs = {tag: Mesh(first + np.arange(int(np.prod([n for _, n in axes])))
                      .reshape([n for _, n in axes]), [a for a, _ in axes])
            for tag, (_, _, axes, first) in plan['mesh_legs'].items()}

    # O1: dp 2 (the two ranks of a tp pair walk the same dp shard)
    cal = run('O1', lambda: _o_calibrate(plan, dev, mesh22))
    out['O1'] = {m: (s, t) for m, (_, s, t) in cal.items()}
    del cal
    # O2: dp 2 x tp 2 on the one-card KL graph
    losses, full, times, grads = run('O2', lambda: _o_train(
        plan, o1_graph, mesh22, dev))
    out['O2'] = dict(losses=losses, step_s=times, grads=grads,
                     coords=mesh22.coords,
                     params=full if rank == 0 else None,
                     digest={k: (float(v.double().sum()),
                                 float(v.abs().max()))
                             for k, v in full.items()})
    del full, grads
    # O3: ring attention over sp 2 (ranks 0, 1) and sp 4
    rings = {}

    def ring():
        q, k, v = _o_qkv(plan, dev)
        for n, mesh in sp.items():
            if mesh.coords is None:
                continue
            T = q.shape[1] // n
            i = mesh.index('sp')
            part = slice(i * T, (i + 1) * T)
            for causal in (True, False):
                rings[(n, causal)] = sequence_parallel_attention(
                    q[:, part], k[:, part], v[:, part], mesh,
                    causal=causal).cpu()
    run('O3', ring)
    out['O3'] = rings
    cfg = LlamaConfig(**plan['serve'])
    params = _o_llama_params(cfg, 0, dev)

    # O4: GPipe over pp 2 (ranks 0, 1) on the stacked layers
    def pipe():
        if pp2.coords is None:
            return None
        cfg.use_kernel_matmul = True
        stacked = stack_layer_params(params['layers'])
        return pipeline_forward(stacked, _o_pipe_input(plan, params, dev),
                                _o_block(cfg), pp2,
                                microbatches=plan['pipe']['microbatches']
                                ).cpu()
    out['O4'] = run('O4', pipe)
    # O5: tp 2 (ranks 0, 1): INT8 dense, ragged, paged; INT4
    serve = {}

    def o5():
        if tp2.coords is None:
            return
        params4 = _o_llama_params(_o_variant(plan, 'int4_ragged'), 0, dev)
        for name in PAR_VARIANTS:
            vcfg = _o_variant(plan, name)
            t0 = time.perf_counter()
            serve[name] = _o_serve(
                vcfg, params4 if vcfg.weight_bits == 4 else params, tp2,
                _o_serve_requests(plan, vcfg), plan['fills'], dev)
            out['seconds'][f'O5 {name}'] = time.perf_counter() - t0
    run('O5', o5)
    out['O5'] = serve
    # O6: dp 2 x tp 2, the paged INT8 engine on all four ranks
    pcfg = _o_variant(plan, 'int8_paged')
    out['O6'] = run('O6', lambda: _o_serve(
        pcfg, params, mesh22, _o_serve_requests(plan, pcfg),
        plan['fills'][:1], dev))
    # O8-O13: the pipeline and sequence meshes, the two-rank legs a pair
    # at a time (O8 on ranks 0, 1 beside O9 on 2, 3)
    out['mesh'] = {}

    def mesh_legs(tags):
        for tag in tags:
            if legs[tag].coords is None:
                continue
            mcfg = _o_mesh_config(plan, tag)
            t0 = time.perf_counter()
            out['mesh'][tag] = _o_serve(
                mcfg, params, legs[tag], _o_mesh_requests(plan, mcfg),
                plan['fills'], dev, repeat=bool(mcfg.prefix_cache_blocks),
                sync=plan['mesh_sync'], steps=plan['mesh_decode_steps'])
            out['seconds'][tag] = time.perf_counter() - t0
    for tags in (('O8', 'O9'), ('O10',), ('O11',), ('O12',), ('O13',)):
        tags = [t for t in tags if t in legs]
        if tags:
            run('+'.join(tags), lambda: mesh_legs(tags))
    del params
    _empty(dev)

    # O7: path M's MoE engine (8 experts, top 2, 2 layers) at ep 2
    def o7():
        if ep2.coords is None:
            return None
        mcfg = LlamaConfig(**plan['moe'])
        return _o_serve(mcfg, _o_llama_params(mcfg, 0, dev), ep2,
                        _o_moe_requests(plan, mcfg), plan['fills'][:1], dev)
    out['O7'] = run('O7', o7)
    out['seconds']['path'] = time.perf_counter() - t_path
    return out


def _o_hold_serving(tag, ranks, one, params, cfg, dev, same_launches=True):
    """Every rank's tokens equal; the tokens against the one-card engine's by
    path G's near-tie rule; the probe logits within SERVE_LOGIT_TOL of the
    largest |logit|. same_launches: every rank launched each serving row
    as often as one card did on the same run (a tp rank's shard takes every
    kernel one card's whole weight takes; not so for an expert-parallel
    rank, which runs its share of the experts); 'reads': so in the decode
    bursts (`decode_launches`), with the two read kernels (rows 11 and 12)
    counted together (a sequence shard reads its positions whole, where one
    card's bucket may pick the per-slot kernel; a pp stage runs its L / pp
    layers on each of pp microbatches, L launches a step as one card; a
    chunked prefill's single row is one microbatch, half of one card's,
    and is reported only)."""
    import types
    for r in ranks[1:]:
        if r['tokens'] != ranks[0]['tokens']:
            raise AssertionError(f'path O {tag}: ranks took other tokens')

    key = 'decode_launches' if same_launches == 'reads' else 'launches'

    def rows(launches):
        out = {k: launches.get(k, 0) for k in PAR_SERVE_ROWS}
        if same_launches == 'reads':
            out['reads'] = sum(out.pop(k) for k in PAR_READ_ROWS)
        return out
    counts = {k: [rows(one[key])[k]] + [rows(r[key])[k] for r in ranks]
              for k in rows(one[key])}
    counts = {k: v for k, v in counts.items() if any(v)}
    if same_launches and any(len(set(v)) > 1 for v in counts.values()):
        raise AssertionError(f'path O {tag}: launches (one card, then each '
                             f'rank) differ: {counts}')
    got = ranks[0]
    want = one['logits']
    worst = float((got['logits'] - want).abs().max() / want.abs().max())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f'path O {tag}: logits {worst} of the largest '
                             f'|logit| from one card')

    def reqs(run):
        return [types.SimpleNamespace(rid=i, prompt=p, generated=t)
                for i, (p, t) in enumerate(zip(run['prompts'],
                                               run['tokens']))]
    held = _near_tie_tokens(f'O {tag}', reqs(one), reqs(got), params, cfg,
                            dev)
    held['logits_max_diff_share_of_scale'] = worst
    held['launches_one_card_then_ranks'] = counts
    return held


def _o_hold_mesh_legs(plan, ranks, params, dev):
    """O8-O13 against one card's engine on the same requests (the dense
    engine with the ragged read for O8 and O9, the paged one for the rest,
    its repeat of the first prompt for O12's prefix-cache hit): every
    rank's tokens equal and held by the near-tie rule, the probe logits
    within SERVE_LOGIT_TOL, no fault bit, each rank launching every
    serving row of its leg as often as one card (a pp stage runs its
    layers on each of pp microbatches, L / pp x pp = L launches of rows 8
    and 10 a step; an sp rank runs every layer, read and write), and on
    the paged sp legs a slot's blocks on two shards."""
    out, refs = {}, {}
    for tag, (name, fields, axes, _) in plan['mesh_legs'].items():
        cfg = _o_mesh_config(plan, tag)
        key = 'paged' if cfg.paged_kv else 'dense'
        if key not in refs:
            rcfg = _o_mesh_config(plan, tag)
            rcfg.prefix_cache_blocks = 0
            refs[key] = _o_serve(rcfg, params, None,
                                 _o_mesh_requests(plan, rcfg), plan['fills'],
                                 dev, repeat=cfg.paged_kv,
                                 sync=plan['mesh_sync'],
                                 steps=plan['mesh_decode_steps'])
        one = refs[key]
        mine = [r['mesh'][tag] for r in ranks if tag in r['mesh']]
        if len(mine) != int(np.prod([n for _, n in axes])):
            raise AssertionError(f'path O {tag}: {len(mine)} ranks reported')
        shape = dict(axes)
        held = _o_hold_serving(f'{tag} {name}', mine, one, params, cfg, dev,
                               same_launches='reads')
        faults = sorted({f for r in mine for f in r['faults']})
        spans = [r['spans'] for r in mine]
        held.update(run_launches_one_card_then_ranks={
                        k: [one['launches'].get(k, 0)] +
                        [r['launches'].get(k, 0) for r in mine]
                        for k in PAR_SERVE_ROWS if one['launches'].get(k)
                        or any(r['launches'].get(k) for r in mine)},
                    run_s=mine[0]['run_s'], ms_per_step=mine[0]['decode'],
                    rank_s=[r['run_s'] for r in mine],
                    one_card_run_s=one['run_s'],
                    one_card_ms_per_step=one['decode'],
                    collectives_a_step=mine[0]['collectives'], faults=faults,
                    block_spans=spans)
        if faults:
            raise AssertionError(f'path O {tag}: fault bits {faults}')
        if cfg.paged_kv and shape.get('sp', 1) > 1 and min(spans) < 2:
            raise AssertionError(f'path O {tag}: no slot held blocks of two '
                                 f'shards: {spans}')
        if 'repeat' in mine[0]:
            rep = mine[0]['repeat']
            if any(r['repeat']['tokens'] != rep['tokens'] for r in mine):
                raise AssertionError(f'path O {tag}: ranks repeated other '
                                     'tokens')
            import types

            def as_reqs(entry):
                return [types.SimpleNamespace(rid=0, prompt=entry['prompt'],
                                              generated=entry['tokens'])]
            held['repeat'] = _near_tie_tokens(
                f'O {tag} repeat', as_reqs(one['repeat']), as_reqs(rep),
                params, cfg, dev)
            held['repeat'].update({k: rep.get(k) for k in
                                   ('hits', 'misses', 'cache')})
            if cfg.prefix_cache_blocks and not rep.get('hits'):
                raise AssertionError(f'path O {tag}: the repeated prompt '
                                     f'did not hit the prefix cache: {rep}')
        out[tag] = held
        log(f'[path O] {tag} {name} {json.dumps(held)}')
    return out


def phase_path_o(dev, plan=PAR_PLAN):
    """Path O: the parallel layer on a world of PAR_WORLD ranks sharing the
    card (spawned; gloo, collectives staged through the host). O1 dp-2
    compiled calibration of ResNet-18 (percentile and KL, 4 batches of 32
    at 224²), O2 the dp 2 x tp 2 sharded step (3 steps), O3 ring attention
    over sp 2 and 4 at the 1B decoder's heads (T 4096, bf16, causal and
    full), O4 the GPipe forward over pp 2 of its 16 layers, O5 its tp-2
    engines (INT8 dense, ragged, paged; INT4), O6 the dp 2 x tp 2 paged
    engine, O7 path M's MoE engine at ep 2. Each is held against the same
    computation on one card in this process (`plan` sets the sizes; on the
    CPU, where no kernel launches, at a small plan it rehearses the path).
    Returns the launches summed over ranks and the summary."""
    from ppq_tpu_torch.kernels import LAUNCHES
    from ppq_tpu_torch.parallel import make_mesh, spawn
    from ppq_tpu_torch.serving import LlamaConfig
    from ppq_tpu_torch.serving.ring_attention import reference_attention
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _empty(dev)
    t_path = time.perf_counter()
    summary = dict(world=PAR_WORLD, label='ms a step and seconds of ranks '
                   'that share one card over gloo: a correctness figure, '
                   'not a scaling figure')
    # one card first: O1's scales, and O2's starting graph and step
    cal = _o_calibrate(plan, dev)
    kl_graph = cal['kl'][0]
    one_step = _o_train(plan, kl_graph, make_mesh(1, dp=1, tp=1), dev)
    halves = _o_train_in_halves(plan, kl_graph, dev)
    _empty(dev)
    t0 = time.perf_counter()
    ranks = spawn(PAR_WORLD, _path_o_rank, (kl_graph, plan),
                  device=dev.type, timeout=900)
    summary['world_s'] = time.perf_counter() - t0
    r0 = ranks[0]
    summary['backend'] = r0['backend']
    summary['transport'] = r0['transport_kind']
    log(f'[path O] world of {PAR_WORLD} ranks on one card: backend '
        f'{r0["backend"]}, transport {r0["transport_kind"]}; '
        f'{summary["world_s"]:.1f} s')
    for r in ranks:
        log(f'[path O] rank {r["rank"]} seconds {json.dumps(r["seconds"])}')
        log(f'[path O] rank {r["rank"]} launches {json.dumps(r["launches"])}')
        log(f'[path O] rank {r["rank"]} collectives '
            f'{json.dumps(r["transport"])}')

    # O1: every rank's scales against one card's
    o1 = {}
    for method in ('percentile', 'kl'):
        want = cal[method][1]
        worst = 0.0
        for r in ranks:
            got = r['O1'][method][0]
            if sorted(got) != sorted(want) or not want:
                raise AssertionError(f'path O O1 {method}: other sites')
            for key in want:
                worst = max(worst, float(np.max(
                    np.abs(got[key] - want[key]) / np.abs(want[key]))))
        o1[method] = dict(sites=len(want), max_rel_diff=worst,
                          one_card_s=cal[method][2],
                          rank_s=[r['O1'][method][1] for r in ranks])
    o1['limit'] = PAR_CALIB_RTOL
    summary['O1'] = o1
    log(f'[path O] O1 {json.dumps(o1)}')
    if max(o1[m]['max_rel_diff'] for m in ('percentile', 'kl')) > \
            PAR_CALIB_RTOL:
        raise AssertionError(f'path O O1: scales from one card: {o1}')
    del cal

    # O2: losses and parameters against one card's step, walked in halves
    # (tight) and all at once (losses held, weights reported), and the
    # first step's gradients against one card's on the whole batch
    got = r0['O2']['params']

    def apart(losses, full):
        rel = max(abs(a - b) / abs(b) for r in ranks
                  for a, b in zip(r['O2']['losses'], losses))
        return rel, max(float((got[k] - full[k]).abs().max()) for k in full)
    same = all(r['O2']['digest'] == r0['O2']['digest'] and
               r['O2']['losses'] == r0['O2']['losses'] for r in ranks)
    rel, diff = apart(*halves[:2])
    rel_whole, diff_whole = apart(*one_step[:2])
    grad_rel = max(_o_grad_apart(r['O2']['grads'], one_step[3],
                                 r['O2']['coords']) for r in ranks)
    grad_halves = max(_o_grad_apart(r['O2']['grads'], halves[2],
                                    r['O2']['coords']) for r in ranks)
    summary['O2'] = dict(losses=r0['O2']['losses'], halves_losses=halves[0],
                         one_card_losses=one_step[0],
                         loss_max_rel_diff=rel, param_max_abs_diff=diff,
                         whole_loss_max_rel_diff=rel_whole,
                         whole_param_max_abs_diff_reported=diff_whole,
                         first_step_grad_rel_diff=grad_rel,
                         halves_first_step_grad_rel_diff=grad_halves,
                         ranks_equal=same,
                         limits=dict(loss_rtol=PAR_LOSS_RTOL,
                                     param_atol=PAR_PARAM_ATOL,
                                     whole_loss_rtol=PAR_WHOLE_LOSS_RTOL,
                                     grad_rtol=PAR_GRAD_RTOL,
                                     halves_grad_rtol=PAR_LOSS_RTOL),
                         step_s=r0['O2']['step_s'],
                         one_card_step_s=one_step[2])
    log(f'[path O] O2 {json.dumps(summary["O2"])}')
    if not same or rel > PAR_LOSS_RTOL or diff > PAR_PARAM_ATOL or \
            rel_whole > PAR_WHOLE_LOSS_RTOL or not grad_rel <= PAR_GRAD_RTOL \
            or not grad_halves <= PAR_LOSS_RTOL:
        raise AssertionError(f'path O O2: {summary["O2"]}')
    del one_step, halves, got

    # O3: the chunks joined against reference_attention on one card
    q, k, v = _o_qkv(plan, dev)
    o3 = {}
    for causal in (True, False):
        want = reference_attention(q, k, v, causal=causal).float().cpu()
        scale = float(want.abs().max())
        for n in (2, 4):
            joined = torch.cat([ranks[i]['O3'][(n, causal)]
                                for i in range(n)], dim=1).float()
            o3[f'sp{n}_{"causal" if causal else "full"}'] = \
                float((joined - want).abs().max()) / scale
    summary['O3'] = dict(max_diff_share_of_scale=o3, limit=PAR_RING_TOL,
                         rank_s=[r['seconds']['O3'] for r in ranks])
    log(f'[path O] O3 {json.dumps(summary["O3"])}')
    if max(o3.values()) > PAR_RING_TOL:
        raise AssertionError(f'path O O3: {o3}')
    del q, k, v

    # O4: the pipeline against the flat walk on one card
    cfg = LlamaConfig(**plan['serve'])
    params = _o_llama_params(cfg, 0, dev)
    cfg.use_kernel_matmul = True
    block = _o_block(cfg)
    mbs = _o_pipe_input(plan, params, dev).chunk(plan['pipe']['microbatches'])
    walked = []
    with torch.no_grad():
        for x in mbs:
            for layer in params['layers']:
                x = block(layer, x)
            walked.append(x)
    want = torch.cat(walked).float().cpu()
    scale = float(want.abs().max())
    summary['O4'] = dict(max_diff_share_of_scale=[
        float((r['O4'].float() - want).abs().max()) / scale
        for r in ranks[:2]], limit=PAR_PIPE_TOL,
        rank_s=[r['seconds']['O4'] for r in ranks])
    log(f'[path O] O4 {json.dumps(summary["O4"])}')
    if max(summary['O4']['max_diff_share_of_scale']) > PAR_PIPE_TOL:
        raise AssertionError(f'path O O4: {summary["O4"]}')

    # O5-O7: the engines against one card's
    o5 = {}
    params4 = _o_llama_params(_o_variant(plan, 'int4_ragged'), 0, dev)
    for name in PAR_VARIANTS:
        vcfg = _o_variant(plan, name)
        p = params4 if vcfg.weight_bits == 4 else params
        one = _o_serve(vcfg, p, None, _o_serve_requests(plan, vcfg),
                       plan['fills'], dev)
        mine = [r['O5'][name] for r in ranks[:2]]
        o5[name] = _o_hold_serving(name, mine, one, p,
                                   _o_variant(plan, name), dev)
        o5[name].update(run_s=mine[0]['run_s'],
                        ms_per_step=mine[0]['decode'],
                        one_card_run_s=one['run_s'],
                        one_card_ms_per_step=one['decode'])
    del params4
    summary['O5'] = o5
    pcfg = _o_variant(plan, 'int8_paged')
    one = _o_serve(pcfg, params, None, _o_serve_requests(plan, pcfg),
                   plan['fills'][:1], dev)
    summary['O6'] = _o_hold_serving('dp2tp2_paged', [r['O6'] for r in ranks],
                                    one, params, _o_variant(plan, 'int8_paged'),
                                    dev)
    summary['O6'].update(run_s=r0['O6']['run_s'],
                         ms_per_step=r0['O6']['decode'],
                         one_card_run_s=one['run_s'],
                         one_card_ms_per_step=one['decode'])
    summary['mesh'] = _o_hold_mesh_legs(plan, ranks, params, dev)
    del params
    _empty(dev)
    mcfg = LlamaConfig(**plan['moe'])
    mparams = _o_llama_params(mcfg, 0, dev)
    one = _o_serve(mcfg, mparams, None, _o_moe_requests(plan, mcfg),
                   plan['fills'][:1], dev)
    summary['O7'] = _o_hold_serving('moe_ep2', [r['O7'] for r in ranks[:2]],
                                    one, mparams, LlamaConfig(**plan['moe']),
                                    dev, same_launches=False)
    summary['O7'].update(run_s=r0['O7']['run_s'],
                         ms_per_step=r0['O7']['decode'],
                         one_card_run_s=one['run_s'],
                         one_card_ms_per_step=one['decode'])
    del mparams
    _empty(dev)
    log(f'[path O] O5-O7 {json.dumps({k: summary[k] for k in ("O5", "O6", "O7")})}')

    # the launches: summed over ranks; rows 1-5 on O1-O2, the serving rows
    # on O5-O6
    launches = {k: 0 for k in LAUNCHES}
    by_step = {}
    for r in ranks:
        for step, counts in r['launches'].items():
            for k, v in counts.items():
                launches[k] += v
                by_step.setdefault(step, {}).setdefault(k, 0)
                by_step[step][k] += v
    summary['launches_by_step'] = by_step
    summary['path_s'] = time.perf_counter() - t_path
    log(f'[path O] launches by step (summed over ranks) {json.dumps(by_step)}')
    log(f'[path O] {summary["path_s"]:.1f} s')
    if dev.type == 'cuda':
        mesh_steps = tuple(s for s in by_step if s.startswith('O8')
                           or s in ('O10', 'O11', 'O12', 'O13'))
        for rows, steps in ((PAR_QUANT_ROWS, ('O1', 'O2')),
                            (PAR_SERVE_ROWS, ('O5', 'O6')),
                            (PAR_MESH_ROWS + ('window_write', 'pool_write'),
                             mesh_steps)):
            missing = [k for k in rows if not sum(
                by_step.get(s, {}).get(k, 0) for s in steps)]
            if missing:
                raise AssertionError(f'path O {steps}: no launch of '
                                     f'{missing}')
    return launches, summary


def main_parallel() -> int:
    """Path O alone: the parallel layer on ranks that share the card."""
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    phase_build()
    launches, _ = phase_path_o(dev)
    log(f'[launches] path O {json.dumps(launches)}')
    _check_path_kernels('O', launches)
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == '--llm-cpu-reference':
        return main_llm_cpu_reference(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == '--api-cpu-reference':
        return main_api_cpu_reference(sys.argv[2])
    if len(sys.argv) > 1:
        import argparse
        ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
        mode = ap.add_mutually_exclusive_group(required=True)
        mode.add_argument('--qmm', action='store_true',
                          help='rows 8, 9 and 10 alone: build, hold, time')
        mode.add_argument('--attention', action='store_true',
                          help='rows 11-14 alone: build, hold, time')
        mode.add_argument('--quant', action='store_true',
                          help='rows 1-7 alone, rows 2, 3 and 5 at every '
                               'path shape: build, hold, time')
        mode.add_argument('--compiled', action='store_true',
                          help='path H alone: the compiled calibration and '
                               'runners, held against the observer path')
        mode.add_argument('--frontends', action='store_true',
                          help='path I alone: ONNX in, quantize, export, '
                               'the exported files run again')
        mode.add_argument('--ops', action='store_true',
                          help='path J alone: the op sweep, BERT-base INT8 '
                               'and FP8, the other zoo graphs')
        mode.add_argument('--passes', action='store_true',
                          help='path K alone: equalization and the other '
                               'passes, the analyses, the evaluation '
                               'harnesses')
        mode.add_argument('--serving', action='store_true',
                          help="path L alone: bench.py's serving track "
                               "(planned loop, mixed, open-loop sweep, "
                               "B=32 decode points)")
        mode.add_argument('--llm', action='store_true',
                          help='path M alone: AWQ, GPTQ, SmoothQuant W8A8, '
                               'MoE and speculative decoding at the 1B '
                               "decoder's full width")
        mode.add_argument('--api', action='store_true',
                          help='path N alone: every platform, PFL, QAT, '
                               'deploy and data I/O at full width')
        mode.add_argument('--parallel', action='store_true',
                          help='path O alone: meshes, dp calibration, the '
                               'sharded step, ring attention, GPipe and '
                               'tp / dp x tp / ep serving on ranks that '
                               'share the card')
        mode.add_argument('--fp8-sample', action='store_true',
                          help="path C's and BERT-base's FP8 calibration "
                               "under DirectMSE's sample rules")
        ap.add_argument('--package-root', default=None,
                        help='import ppq_tpu_torch from this checkout')
        args = ap.parse_args()
        if args.attention:
            return main_attention(args.package_root)
        if args.quant:
            return main_quant(args.package_root)
        if args.compiled:
            return main_compiled()
        if args.frontends:
            return main_frontends()
        if args.ops:
            return main_ops()
        if args.passes:
            return main_passes()
        if args.serving:
            return main_serving()
        if args.fp8_sample:
            return main_fp8_sample(args.package_root)
        if args.llm:
            return main_llm()
        if args.api:
            return main_api()
        if args.parallel:
            return main_parallel()
        return main_qmm(args.package_root)
    t_start = time.perf_counter()
    name, smi = phase_card()
    import ppq_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    seconds = {}

    def timed(tag, fn, *args):
        """fn(*args), its seconds logged and kept for the last lines."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[tag] = round(time.perf_counter() - t0, 1)
        log(f'[time] {tag} {seconds[tag]} s')
        return out

    timed('build', phase_build)
    kernel_results = timed('kernels', phase_kernels, dev)
    launches_a, _, pct_graph, kl_graph = timed('A', phase_main_path, dev)
    launches_h, _ = timed('H', phase_path_h, dev, pct_graph, kl_graph)
    del pct_graph
    launches_i, _ = timed('I', phase_path_i, dev)
    launches_j, _ = timed('J', phase_path_j, dev)
    launches_k, _ = timed('K', phase_path_k, dev)
    api_reference = _api_cpu_reference()
    try:
        launches_n, _ = timed('N', phase_path_n, dev, api_reference)
    finally:
        api_reference.close()
    launches_b, _, lsq_graph, train_loader = timed('B', phase_path_b, dev,
                                                   kl_graph)
    launches_c, _, fp8_graph, _ = timed('C', phase_path_c, dev)
    # path M's CPU half runs beside the serving paths
    reference = _CpuReference()
    try:
        launches_d, _, serve_params = timed('D', phase_path_d, dev)
        launches_e, _ = timed('E', phase_path_e, dev, serve_params)
        launches_g, _ = timed('G', phase_path_g, dev, serve_params)
        launches_f, _, int4_params = timed('F', phase_path_f, dev)
        launches_l, _ = timed('L', phase_path_l, dev, serve_params,
                              int4_params)
        del serve_params, int4_params
        torch.cuda.empty_cache()
        launches_m, _ = timed('M', phase_path_m, dev, reference)
    finally:
        reference.close()
    torch.cuda.empty_cache()
    launches_o, _ = timed('O', phase_path_o, dev)
    paths = dict(A=launches_a, H=launches_h, I=launches_i, J=launches_j,
                 K=launches_k, N=launches_n, B=launches_b, C=launches_c,
                 D=launches_d, E=launches_e, F=launches_f, G=launches_g,
                 L=launches_l, M=launches_m, O=launches_o)
    # each path's counts were set to 0 before it and read just after it
    launches = {k: sum(p[k] for p in paths.values()) for k in launches_a}
    for tag, counts in paths.items():
        log(f'[launches] path {tag} {json.dumps(counts)}')
    for tag in ('D', 'E', 'F', 'G', 'L', 'M', 'N', 'O'):
        _check_path_kernels(tag, paths[tag])
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on any path: {missing}')
    t0 = time.perf_counter()
    phase_lsq_steps('int8', lsq_graph, train_loader, scales_trainable=True,
                    profile_first=True)
    phase_lsq_steps('fp8', fp8_graph, train_loader, scales_trainable=False,
                    profile_first=False)
    seconds['lsq steps'] = round(time.perf_counter() - t0, 1)
    line = {'kernels': [
        {'name': k, 'route': 'cuda', 'source': KERNELS[k][0],
         'replaces': KERNELS[k][1], 'launches': launches[k],
         'max_abs_err': kernel_results[k]['max_abs_err'],
         'ms': kernel_results[k]['ms'], 'plain_ms': kernel_results[k]['plain_ms'],
         'bound_ms': kernel_results[k]['bound_ms'],
         'bound_by': kernel_results[k]['bound_by'],
         'library_ms': kernel_results[k]['library_ms']} for k in KERNELS]}
    log(f'[done] {time.perf_counter() - t_start:.1f} s, by phase '
        f'{json.dumps(seconds)}; {smi}')
    log(json.dumps(line))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
