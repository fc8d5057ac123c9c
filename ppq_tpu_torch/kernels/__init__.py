"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

| TPU kernel (ppq_tpu/kernels)                  | here                       |
|-----------------------------------------------|----------------------------|
| quant.pallas_linear_quant, tensorwise         | quant.linear_quant         |
| quant.pallas_linear_quant, channelwise        | quant.linear_quant         |
| histogram.pallas_histogram                    | histogram.histogram        |

The kernels are built by `loader.build()` at first use; a wrapper given a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises.
"""

from .loader import LAUNCHES, build, reset_launches
from .histogram import histogram, histogram_plain
from .quant import linear_quant, linear_quant_plain

__all__ = ['LAUNCHES', 'build', 'reset_launches', 'histogram',
           'histogram_plain', 'linear_quant', 'linear_quant_plain']
