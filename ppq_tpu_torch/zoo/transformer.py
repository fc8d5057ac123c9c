"""Transformer-family test/benchmark models in the ONNX-semantic IR
(BASELINE.json configs: "BERT-base INT8 vs FP8" — the graphs mirror what a
HuggingFace BERT ONNX export contains: MatMul/Add/LayerNormalization/
Softmax/Gelu/Transpose/Reshape chains)."""

from __future__ import annotations

import numpy as np

from ..ir import BaseGraph
from .builder import NetBuilder


def bert_encoder(seq_len: int = 128, d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 2, d_ff: int = 512, vocab: int = 1000,
                 batch: int = 1, seed: int = 0) -> BaseGraph:
    """BERT-style encoder over pre-embedded inputs.

    Input: (batch, seq_len, d_model) float embeddings (embedding lookup is
    host-side in deployment; quantization concerns the encoder stack —
    reference treats bert the same way, ppq/samples/bert_sample.py).
    """
    b = NetBuilder('bert_encoder', seed)
    dh = d_model // n_heads
    x = b.input('embeddings', [batch, seq_len, d_model])

    def layer_norm(v):
        return b.op('LayerNormalization', [
            v, b.param(np.ones(d_model)), b.param(np.zeros(d_model))],
            axis=-1, epsilon=1e-5)

    def dense(v, cin, cout):
        w = b.param(b.rng.randn(cin, cout) * np.sqrt(1.0 / cin))
        bias = b.param(b.rng.randn(cout) * 0.01)
        return b.op('Add', [b.matmul(v, w), bias])

    h = x
    for _ in range(n_layers):
        # --- self attention ------------------------------------------------
        q = dense(h, d_model, d_model)
        k = dense(h, d_model, d_model)
        v = dense(h, d_model, d_model)

        def split_heads(t):
            # 0 = copy batch dim from input (onnx Reshape semantics) —
            # keeps the graph batch-size agnostic like real exports
            t = b.reshape(t, [0, seq_len, n_heads, dh])
            return b.transpose(t, [0, 2, 1, 3])       # (B, H, T, dh)

        qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
        kt = b.transpose(kh, [0, 1, 3, 2])            # (B, H, dh, T)
        scores = b.matmul(qh, kt)
        scores = b.op('Mul', [scores,
                              b.param(np.asarray(1.0 / np.sqrt(dh)))])
        probs = b.softmax(scores, axis=-1)
        ctx = b.matmul(probs, vh)                     # (B, H, T, dh)
        ctx = b.transpose(ctx, [0, 2, 1, 3])
        ctx = b.reshape(ctx, [0, seq_len, d_model])
        attn_out = dense(ctx, d_model, d_model)
        h = layer_norm(b.add(h, attn_out))

        # --- FFN -----------------------------------------------------------
        ff = b.op('Gelu', [dense(h, d_model, d_ff)])
        ff = dense(ff, d_ff, d_model)
        h = layer_norm(b.add(h, ff))

    b.output(h)
    return b.g


def mha_fused_encoder(seq_len: int = 64, d_model: int = 128, n_heads: int = 4,
                      batch: int = 1, seed: int = 0) -> BaseGraph:
    """Single-op MultiHeadAttention variant (reference op
    ppq/executor/op/torch/default.py:586) — exercises the fused-attention
    executor path."""
    b = NetBuilder('mha_encoder', seed)
    x = b.input('x', [batch, seq_len, d_model])
    wq = b.param(b.rng.randn(d_model, d_model) * 0.05)
    wk = b.param(b.rng.randn(d_model, d_model) * 0.05)
    wv = b.param(b.rng.randn(d_model, d_model) * 0.05)
    wo = b.param(b.rng.randn(d_model, d_model) * 0.05)
    bq = b.param(np.zeros(d_model))
    bk = b.param(np.zeros(d_model))
    bv = b.param(np.zeros(d_model))
    bo = b.param(np.zeros(d_model))
    out = b.op('MultiHeadAttention',
               [x, x, x, wq, wk, wv, wo, bq, bk, bv, bo],
               num_heads=n_heads)
    b.output(out)
    return b.g


def crnn_ocr(seq_len: int = 32, in_ch: int = 1, hidden: int = 48,
             n_classes: int = 37, batch: int = 1, seed: int = 0) -> BaseGraph:
    """CRNN-style OCR model (conv feature extractor → LSTM → classifier) —
    the IC15 OCR family of the QuantZoo protocol; exercises the LSTM op
    (reference default.py:2951)."""
    b = NetBuilder('crnn', seed)
    x = b.input('image', [batch, in_ch, 32, 4 * seq_len])
    y = b.relu(b.conv(x, in_ch, 16, 3))
    y = b.maxpool(y, 2, 2)
    y = b.relu(b.conv(y, 16, 32, 3))
    y = b.maxpool(y, 2, 2)              # (B, 32, 8, seq_len)
    y = b.op('ReduceMean', [y], axes=[2], keepdims=0)   # (B, 32, T)
    y = b.transpose(y, [2, 0, 1])       # (T, B, 32) ONNX LSTM layout
    w = b.param(b.rng.randn(1, 4 * hidden, 32) * 0.1)
    r = b.param(b.rng.randn(1, 4 * hidden, hidden) * 0.1)
    bias = b.param(np.zeros((1, 8 * hidden)))
    outs = b.op('LSTM', [y, w, r, bias], n_out=3, hidden_size=hidden,
                direction='forward')
    seq_out = outs[0]                  # (T, 1, B, hidden)
    seq_out = b.reshape(seq_out, [seq_len, batch, hidden])
    logits = b.matmul(seq_out, b.param(b.rng.randn(hidden, n_classes) * 0.1))
    b.output(logits)
    return b.g
