"""Similarity / error metrics (reference: ppq/quantization/measure/)."""

from __future__ import annotations

import torch


def _flatten_batch(x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32)
    if x.ndim == 0:
        return x.reshape(1, 1)
    return x.reshape(x.shape[0], -1)


def torch_mean_square_error(a, b, reduction: str = 'mean') -> torch.Tensor:
    """(measure/norm.py:3)"""
    a, b = _flatten_batch(a), _flatten_batch(b)
    mse = torch.mean((a - b) ** 2, dim=-1)
    return torch.mean(mse) if reduction == 'mean' else mse


def torch_snr_error(pred, real, reduction: str = 'mean') -> torch.Tensor:
    """Noise-to-signal power ratio per sample (measure/norm.py:52);
    lower is better, 0 = identical."""
    pred, real = _flatten_batch(pred), _flatten_batch(real)
    noise = torch.sum((pred - real) ** 2, dim=-1)
    signal = torch.sum(real ** 2, dim=-1) + 1e-7
    snr = noise / signal
    return torch.mean(snr) if reduction == 'mean' else snr


def torch_cosine_similarity(a, b, reduction: str = 'mean') -> torch.Tensor:
    """(measure/cosine.py:6)"""
    a, b = _flatten_batch(a), _flatten_batch(b)
    num = torch.sum(a * b, dim=-1)
    den = (torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)) + 1e-7
    cos = num / den
    return torch.mean(cos) if reduction == 'mean' else cos


def torch_KL_divergence(p, q, eps: float = 1e-7) -> torch.Tensor:
    """(measure/statistic.py:3)"""
    p, q = _flatten_batch(p), _flatten_batch(q)
    p = p / (torch.sum(p, dim=-1, keepdim=True) + eps)
    q = q / (torch.sum(q, dim=-1, keepdim=True) + eps)
    return torch.mean(torch.sum(p * torch.log((p + eps) / (q + eps)), dim=-1))


# aliases without the legacy torch_ prefix
mean_square_error = torch_mean_square_error
snr_error = torch_snr_error
cosine_similarity = torch_cosine_similarity
kl_divergence = torch_KL_divergence
