"""Serving engine configuration."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class LlamaConfig:
    """Llama-class decoder architecture + quantization + serving knobs:
    quantized inference with INT8 or INT4 weights (W8A8 prefill with
    act_bits=8), dense or MoE FFNs and an INT8 KV cache on one card.

    The fields are those of the JAX package's `LlamaConfig`; its switch
    `use_pallas_matmul` is `use_kernel_matmul` here, and `batch_invariant`
    is the port's own. Every field's path is ported, and the engine takes
    every mesh the JAX engine takes (tp, dp, ep, pp, sp and their
    compositions).
    """

    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8             # GQA
    d_ff: int = 5632
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048

    # mixture-of-experts (0 = dense FFN)
    n_experts: int = 0
    top_k: int = 2

    # quantization
    weight_bits: int = 8            # 8 | 4 | 16 (16 = bf16, no quant)
    # lm_head precision; None resolves to 8 when weight_bits == 4
    lm_head_bits: Optional[int] = None
    weight_quant_method: str = 'minmax'   # 'minmax' | 'mse' scale search
    # runtime marker set by model.fuse_decode_params when every rms_norm
    # gamma folded into the following matmul's weights: the decode burst
    # then fuses the norm's rsqrt into the matmul kernel's epilogue
    norm_folded: bool = False
    kv_cache_bits: int = 8          # 8 | 16
    act_dtype: str = 'bfloat16'
    act_bits: int = 16              # 16 (bf16 acts) | 8 (W8A8 prefill)

    # serving
    max_batch: int = 8
    prefill_buckets: tuple = (128, 512, 2048)
    # automatic prefix caching (paged_kv only)
    prefix_cache_blocks: int = 0

    # Kernel fast paths (None = resolved at engine build: True on a CUDA
    # device). use_kernel_matmul sends decode-sized matmuls through the
    # fused dequant-matmul kernels (kernels/qmm.py), which read the integer
    # weight bytes; use_ragged_attention reads only filled KV-cache blocks
    # in burst decode through the paged-attention kernels (on a card it
    # resolves True when head_dim and max_seq_len are multiples of 128).
    use_kernel_matmul: Optional[bool] = None
    use_ragged_attention: Optional[bool] = None

    # paged KV cache: sequences draw kv_block_size-token blocks from a
    # shared pool instead of reserving max_batch x max_seq_len up front;
    # kv_pool_blocks None = max_batch * max_seq_len / kv_block_size + 1
    # (trash block 0 included), the contiguous cache's worst case
    paged_kv: bool = False
    kv_pool_blocks: Optional[int] = None
    kv_block_size: int = 256

    # `model.forward` (prefill windows and single steps over the dense
    # cache) computes each token's row as it would alone: its attention
    # products and norms sum in float64, exact for bf16 operands, so a
    # window of T tokens gives the logits of T single steps bit for bit.
    # Greedy speculative decoding's exactness rests on it (speculative.py
    # sets it for its decoders); the matmul kernels are per-row already.
    batch_invariant: bool = False

    # longest single decode burst
    max_decode_burst: int = 128
    # in-burst banked-buffer chunk length (None = one chunk): the current
    # chunk's columns are read masked, finished chunks unmasked
    burst_chunk: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def resolved_lm_head_bits(self) -> int:
        if self.lm_head_bits is not None:
            return self.lm_head_bits
        return 8 if self.weight_bits == 4 else self.weight_bits

    @classmethod
    def tiny(cls) -> 'LlamaConfig':
        """Test-sized config."""
        return cls(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, d_ff=256, max_seq_len=128, max_batch=4,
                   prefill_buckets=(16, 64))
