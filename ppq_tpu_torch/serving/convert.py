"""Checkpoint conversion: HuggingFace Llama-family weights -> engine params,
the JAX package's `ppq_tpu/serving/convert.py`.

Take a trained Llama-architecture checkpoint (a `transformers` state dict,
or any mapping with HF's key names; local files only) and produce the
ServingEngine's parameter tree. Layout differences handled here:

  * torch Linear stores (out, in); the engine's qmatmul consumes (in, out):
    transpose.
  * q/k/v keep HF's head ordering: the engine's rope_apply and HF's
    rotate_half are the same contiguous-half rotation.
  * lm_head ties to the embedding when the checkpoint omits it.

Quantization happens AFTER conversion through the same entry points as
everything else (quantize_llama_params / awq / gptq).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..executor.executor import resolve_device
from .config import LlamaConfig
from .model import BF16, F32, Params, fold_norm_gamma, quantize_llama_params


def config_from_hf(hf_cfg) -> LlamaConfig:
    """LlamaConfig from any object with HF LlamaConfig's attribute names."""
    return LlamaConfig(
        vocab_size=int(hf_cfg.vocab_size),
        d_model=int(hf_cfg.hidden_size),
        n_layers=int(hf_cfg.num_hidden_layers),
        n_heads=int(hf_cfg.num_attention_heads),
        n_kv_heads=int(getattr(hf_cfg, 'num_key_value_heads',
                               hf_cfg.num_attention_heads)),
        d_ff=int(hf_cfg.intermediate_size),
        max_seq_len=int(hf_cfg.max_position_embeddings),
        rope_theta=float(getattr(hf_cfg, 'rope_theta', 10000.0)),
        rms_eps=float(getattr(hf_cfg, 'rms_norm_eps', 1e-5)),
    )


def params_from_hf_state_dict(sd: Dict, cfg: LlamaConfig,
                              quantize: bool = True,
                              method: Optional[str] = None,
                              device=None) -> Params:
    """Engine param tree on `device` (the card unless named) from a HF Llama
    state dict (tensors or numpy arrays). quantize=False returns the float
    tree ({'w': bf16} linears) for the calibrated quantizers (awq / gptq)
    to consume."""
    device = resolve_device(device)

    def a(key) -> torch.Tensor:
        t = sd[key]
        if isinstance(t, torch.Tensor):
            t = t.detach().to('cpu', torch.float32)
        else:
            t = torch.from_numpy(np.asarray(t, np.float32))
        return t.to(device)

    def lin(key):
        return {'w': a(key).T.contiguous().to(BF16)}        # (in, out)

    layers = []
    for i in range(cfg.n_layers):
        p = f'model.layers.{i}.'
        layers.append({
            'attn_norm': a(p + 'input_layernorm.weight'),
            'wq': lin(p + 'self_attn.q_proj.weight'),
            'wk': lin(p + 'self_attn.k_proj.weight'),
            'wv': lin(p + 'self_attn.v_proj.weight'),
            'wo': lin(p + 'self_attn.o_proj.weight'),
            'mlp_norm': a(p + 'post_attention_layernorm.weight'),
            'w_gate': lin(p + 'mlp.gate_proj.weight'),
            'w_up': lin(p + 'mlp.up_proj.weight'),
            'w_down': lin(p + 'mlp.down_proj.weight'),
        })
    head_key = ('lm_head.weight' if 'lm_head.weight' in sd
                else 'model.embed_tokens.weight')     # tied embeddings
    params: Params = {
        'embed': a('model.embed_tokens.weight').to(BF16),
        'layers': layers,
        'final_norm': a('model.norm.weight').to(F32),
        'lm_head': lin(head_key),
    }
    if quantize:
        # fold the norm gammas into the float weights BEFORE quantization:
        # the grid then covers gamma*W, and the decode burst can fuse each
        # rms_norm into the following matmul's row-scale epilogue
        fold_norm_gamma(params)
        params = quantize_llama_params(params, cfg, method=method)
    return params


def load_hf_llama(model_or_path, cfg: Optional[LlamaConfig] = None,
                  quantize: bool = True, method: Optional[str] = None,
                  device=None):
    """(cfg, params) from a transformers model instance (anything with
    `.config` and `.state_dict()`) or a local checkpoint directory, read
    with `from_pretrained` (local files only). `transformers` is imported
    only for a path."""
    if isinstance(model_or_path, str):
        try:
            from transformers import AutoModelForCausalLM
        except ImportError as e:
            raise ImportError(
                'load_hf_llama reads a checkpoint directory through '
                '`transformers`, which is not installed; pass a model '
                'object or use params_from_hf_state_dict on a state '
                'dict') from e
        model_or_path = AutoModelForCausalLM.from_pretrained(
            model_or_path, local_files_only=True)
    if cfg is None:
        cfg = config_from_hf(model_or_path.config)
    params = params_from_hf_state_dict(model_or_path.state_dict(), cfg,
                                       quantize=quantize, method=method,
                                       device=device)
    return cfg, params
