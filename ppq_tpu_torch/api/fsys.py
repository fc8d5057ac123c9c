"""Working-directory file helpers for the beginner flow (port of
ppq_tpu/api/fsys.py).

Reference counterpart: ppq/api/fsys.py (load_calibration_dataset,
load_from_file/dump_to_file, create_dir, comparison helpers) — redesigned
around numpy batches (the executor's native input type) instead of torch
tensors.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from ..core import ppq_info, ppq_warning

__all__ = ['load_calibration_dataset', 'load_from_file', 'dump_to_file',
           'create_dir', 'compare_cosine_similarity_between_results',
           'dump_internal_results']


def create_dir(dir: str) -> None:
    """mkdir -p with a clear error (reference fsys.py:146)."""
    try:
        os.makedirs(dir, exist_ok=True)
    except OSError as e:
        raise OSError(f'Cannot create working directory {dir!r}: {e}')


def _load_one(path: str) -> np.ndarray:
    if path.endswith('.npy'):
        return np.load(path)
    if path.endswith(('.bin', '.raw')):
        return np.fromfile(path, dtype=np.float32)
    raise ValueError(f'Unsupported calibration file {path!r} '
                     f'(expected .npy, .bin or .raw)')


def load_calibration_dataset(directory: str, input_shape: List[int],
                             batchsize: int = 32,
                             input_format: str = 'chw') -> List[np.ndarray]:
    """Load calibration data from `<directory>/data` (reference
    fsys.py:16): every .npy/.bin/.raw file is one sample (or one batch —
    arrays already carrying a leading batch axis pass through), reshaped
    to `input_shape` and grouped into batches of `batchsize`.

    input_format 'hwc' transposes trailing HWC samples into the CHW
    layout the vision zoo uses.
    """
    data_dir = os.path.join(directory, 'data')
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(
            f'Calibration directory {data_dir!r} does not exist; the '
            f'working-directory layout is <dir>/model.onnx + <dir>/data/*.npy')
    # Drop the leading batch entry first (it may be None/dynamic), THEN
    # filter remaining dynamic dims — [None,3,H,W] must keep the channel.
    sample_shape = [d for d in input_shape[1:] if d is not None] \
        if input_shape else None
    samples = []
    for name in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, name)
        if not os.path.isfile(path):
            continue
        try:
            arr = _load_one(path)
        except ValueError:
            ppq_warning(f'Skipping unrecognized calibration file {name!r}')
            continue
        arr = np.asarray(arr, np.float32)
        if sample_shape is not None:
            per = int(np.prod(sample_shape))
            if arr.size % per != 0:
                ppq_warning(f'{name!r} has {arr.size} elements, not a '
                            f'multiple of sample size {per} — skipped')
                continue
            n = arr.size // per
            arr = arr.reshape([n] + list(sample_shape))
        elif arr.ndim >= 1:
            # no input_shape given: treat each file as one sample
            arr = arr[None]
        if input_format.lower() == 'hwc' and arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        samples.append(arr)
    if not samples:
        raise FileNotFoundError(f'No calibration samples under {data_dir!r}')
    flat = np.concatenate(samples, axis=0)
    batches = [flat[i: i + batchsize]
               for i in range(0, len(flat), batchsize)]
    ppq_info(f'Loaded {len(flat)} calibration samples '
             f'({len(batches)} batches of <= {batchsize})')
    return batches


def load_from_file(file_path: str, dtype=np.float32, shape=None,
                   binary: bool = True):
    """(reference fsys.py:107)"""
    if binary:
        arr = np.fromfile(file_path, dtype=dtype)
        return arr.reshape(shape) if shape is not None else arr
    with open(file_path) as f:
        return json.load(f)


def dump_to_file(file_path: str, data, binary: bool = True) -> None:
    """(reference fsys.py:126)"""
    if binary:
        np.asarray(data).tofile(file_path)
    elif isinstance(data, (dict, list)):
        with open(file_path, 'w') as f:
            json.dump(data, f, indent=2)
    else:
        with open(file_path, 'wb') as f:
            pickle.dump(data, f)


def compare_cosine_similarity_between_results(
        ref_dir: str, target_dir: str,
        dtype=np.float32) -> dict:
    """Per-variable cosine similarity between two dumps produced by
    `dump_internal_results` (reference fsys.py:154)."""
    report = {}
    for name in sorted(os.listdir(ref_dir)):
        tgt = os.path.join(target_dir, name)
        if not name.endswith('.bin') or not os.path.isfile(tgt):
            continue
        a = np.fromfile(os.path.join(ref_dir, name), dtype=dtype)
        b = np.fromfile(tgt, dtype=dtype)
        if a.size != b.size or a.size == 0:
            report[name] = None
            continue
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        report[name] = float(a @ b / denom) if denom > 0 else None
    for name, cos in report.items():
        ppq_info(f'{name}: cosine {cos if cos is None else round(cos, 6)}')
    return report


def dump_internal_results(graph, inputs, output_dir: str,
                          executor=None, device=None) -> None:
    """Run the graph and dump every quantable-op output tensor as raw
    float32 next to a `meta.json` (reference fsys.py:197) — feed two such
    dumps to `compare_cosine_similarity_between_results`. Without an
    executor, a TorchExecutor runs on `device`, the card by default."""
    from ..executor import TorchExecutor
    from ..ir.quantize import QuantableOperation
    create_dir(output_dir)
    executor = executor or TorchExecutor(graph, device=device)
    names = [op.outputs[0].name for op in graph.operations.values()
             if isinstance(op, QuantableOperation) and op.outputs]
    values = executor.forward(inputs, output_names=names)
    meta = {}
    for name, value in zip(names, values):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value, np.float32)
        fname = name.replace('/', '_').replace(':', '_') + '.bin'
        arr.tofile(os.path.join(output_dir, fname))
        meta[fname] = {'variable': name, 'shape': list(arr.shape)}
    with open(os.path.join(output_dir, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=2)
    ppq_info(f'Dumped {len(meta)} internal results to {output_dir}')
