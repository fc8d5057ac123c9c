"""Host-side helpers of the port: the native libraries (clip-search
solvers, paged-KV block allocator, npy prefetcher), the seeded tensor
sampling, the npy calibration loader, FLOP counting and the exponential
moving average. `deploy` (export, benchmark, profile) imports the executor
and is imported as `ppq_tpu_torch.utils.deploy`."""

from .dataio import NpyLoader, load_calibration_dir
from .ema import EMARecorder
from .fetch import (batch_random_fetch, channel_random_fetch,
                    tensor_random_fetch)
from .native import (NativeAllocLib, NativeDataLib, NativeSolvers,
                     native_alloc, native_dataio, native_solvers)

__all__ = ['EMARecorder', 'NpyLoader', 'load_calibration_dir',
           'NativeSolvers', 'native_solvers', 'NativeAllocLib',
           'native_alloc', 'NativeDataLib', 'native_dataio',
           'batch_random_fetch', 'channel_random_fetch',
           'tensor_random_fetch']
