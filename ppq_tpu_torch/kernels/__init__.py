"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

| TPU kernel (ppq_tpu/kernels)                  | here                       |
|-----------------------------------------------|----------------------------|
| quant.pallas_linear_quant, tensorwise         | quant.linear_quant         |
| quant.pallas_linear_quant, channelwise        | quant.linear_quant         |
| histogram.pallas_histogram                    | histogram.histogram        |
| quant.pallas_linear_quant_bwd, tensorwise     | quant.linear_quant_bwd     |
| quant.pallas_linear_quant_bwd, channelwise    | quant.linear_quant_bwd     |
| floating.pallas_floating_quant (both bodies)  | floating.floating_quant    |
| floating.pallas_floating_quant_bwd            | floating.floating_quant_bwd|

The kernels are built by `loader.build()` at first use; a wrapper given a
CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises.
"""

from .loader import LAUNCHES, build, reset_launches
from .histogram import histogram, histogram_plain
from .quant import (linear_quant, linear_quant_bwd, linear_quant_bwd_plain,
                    linear_quant_plain)
from .floating import (floating_quant, floating_quant_bwd,
                       floating_quant_bwd_plain, floating_quant_plain)

__all__ = ['LAUNCHES', 'build', 'reset_launches', 'histogram',
           'histogram_plain', 'linear_quant', 'linear_quant_plain',
           'linear_quant_bwd', 'linear_quant_bwd_plain', 'floating_quant',
           'floating_quant_plain', 'floating_quant_bwd',
           'floating_quant_bwd_plain']
