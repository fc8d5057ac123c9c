"""Evaluation & benchmark harnesses
(redesign of ppq/samples/Imagenet/evaluation_with_imagenet.py and the
QuantZoo protocol, samples/QuantZoo/Readme.md:200-236).

Zero-egress environment: harnesses accept any user iterable of
(batch, labels); the QuantZoo-style runner compares quantization schemes on
the AQE / MQE / OQE error metrics, which need no labeled data.

Port of ppq_tpu/zoo/evaluate.py, on the card unless the caller names another
device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..api.setting import QuantizationSettingFactory
from ..core import TargetPlatform, ppq_info
from ..executor import TorchExecutor, compile_graph
from ..executor.executor import resolve_device


def evaluate_classification(graph, dataloader: Iterable,
                            compiled: bool = True,
                            topk: Tuple[int, ...] = (1, 5),
                            device=None) -> Dict[str, float]:
    """Top-k accuracy of a (quantized) classifier graph.

    dataloader yields (batch, labels). Uses the compiled executor — on the
    card one captured CUDA graph per batch shape.
    """
    device = resolve_device(device)
    if compiled:
        run = compile_graph(graph, device=device).make_runner()
        fwd = lambda x: run(x)[0]
    else:
        ex = TorchExecutor(graph, device=device)
        fwd = lambda x: ex.forward(x)[0]

    correct = {k: 0 for k in topk}
    total = 0
    t0 = time.perf_counter()
    for batch, labels in dataloader:
        # the host copy of the logits waits for the card's work on the
        # batch, so images_per_sec times the card, not only its launches
        logits = fwd(batch).detach().cpu().numpy()
        labels = np.asarray(labels).reshape(-1)
        order = np.argsort(-logits, axis=-1)
        for k in topk:
            correct[k] += int((order[:, :k] ==
                               labels[:, None]).any(axis=1).sum())
        total += len(labels)
    dt = time.perf_counter() - t0
    out = {f'top{k}': correct[k] / max(total, 1) for k in topk}
    out['images_per_sec'] = total / max(dt, 1e-9)
    return out


# -------------------------------------------------------------- QuantZoo ---

QUANTZOO_SCHEMES = {
    'INT8_per_channel': (TargetPlatform.TPU_INT8,
                         QuantizationSettingFactory.default_setting),
    'INT8_po2_per_tensor': (TargetPlatform.TPU_POWER_OF_2,
                            QuantizationSettingFactory.default_setting),
    'FP8_E4M3': (TargetPlatform.TPU_FP8,
                 QuantizationSettingFactory.fp8_setting),
}


def quantization_error_metrics(graph, dataloader, steps: int = 4,
                               device=None) -> Dict[str, float]:
    """AQE / MQE / OQE exactly per the QuantZoo/OnnxQuant protocol
    (Readme.md:210-232): RELATIVE Frobenius error per computing layer —
    average / max across layers, and max over graph outputs
    (quantzoo_error_analyse implements the formula)."""
    from ..quantization.analyse import quantzoo_error_analyse
    r = quantzoo_error_analyse(graph, dataloader, steps=steps,
                               verbose=False, device=device)
    return {'AQE': r['AQE'], 'MQE': r['MQE'], 'OQE': r['OQE']}


def quantzoo_benchmark(model_builders: Dict[str, Callable],
                       dataloaders: Dict[str, List],
                       schemes: Optional[List[str]] = None,
                       calib_steps: int = 8,
                       error_steps: int = 4,
                       verbose: bool = True,
                       device=None) -> List[dict]:
    """Cross (model × quantization scheme) benchmark matrix, reporting the
    QuantZoo error metrics per cell."""
    from ..api import quantize_graph
    device = resolve_device(device)
    schemes = schemes or list(QUANTZOO_SCHEMES)
    records = []
    for model_name, builder in model_builders.items():
        loader = dataloaders[model_name]
        for scheme in schemes:
            platform, setting_fn = QUANTZOO_SCHEMES[scheme]
            graph = builder()
            quantize_graph(graph, loader, calib_steps=calib_steps,
                           platform=platform, setting=setting_fn(),
                           verbose=False, device=device)
            metrics = quantization_error_metrics(graph, loader,
                                                 steps=error_steps,
                                                 device=device)
            rec = {'model': model_name, 'scheme': scheme, **metrics}
            records.append(rec)
            if verbose:
                ppq_info(f"QuantZoo {model_name:>16s} | {scheme:<20s} | "
                         f"AQE {metrics['AQE']:.5f} MQE {metrics['MQE']:.5f} "
                         f"OQE {metrics['OQE']:.5f}")
    return records
