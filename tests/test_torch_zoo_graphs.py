"""The port's zoo graphs with SOI dispatch, an LSTM and a ConvTranspose held
against the JAX package's on the CPU, as tests/test_torch_zoo.py holds
small BERT: `quantize_graph` in both packages (TQC states, scales, the
simulated forward), and the compiled 'int' logits of `unet_lite` bit for
bit."""

import pytest

from test_torch_zoo import (_one_torch_thread, hold_int_logits,  # noqa: F401
                            hold_quantized, quantized)


@pytest.mark.parametrize('key', ['yolo', 'crnn', 'unet'])
def test_quantize_graph_matches_jax(quantized, key):  # noqa: F811
    hold_quantized(quantized, key)


def test_int_logits_equal_jax(quantized):  # noqa: F811
    hold_int_logits(quantized, 'unet')
