"""Global framework configuration (ppq/core/config.py:1-21 equivalent).

On a CUDA tensor the hand-written kernels always run, so the port has no
counterpart of the JAX package's `USING_PALLAS_KERNEL` switch."""


class _GlobalConfig:
    """Mutable singleton of framework-wide switches."""

    def __init__(self):
        self.VERSION = '0.1.0'
        self.NAME = 'ppq_tpu_torch'
        # dump tensor values when exporting
        self.DUMP_VALUE_WHEN_EXPORT = False
        self.EXPORT_INTERNAL_INFO = False
        self.DEBUG = False


PPQ_TPU_CONFIG = _GlobalConfig()
