"""Host-side helpers of the port: the native clip-search solvers and the
seeded tensor sampling."""

from .fetch import (batch_random_fetch, channel_random_fetch,
                    tensor_random_fetch)
from .native import NativeSolvers, native_solvers

__all__ = ['NativeSolvers', 'native_solvers', 'batch_random_fetch',
           'channel_random_fetch', 'tensor_random_fetch']
