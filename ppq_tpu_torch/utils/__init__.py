"""Host-side helpers of the port: the native clip-search solvers."""

from .native import NativeSolvers, native_solvers

__all__ = ['NativeSolvers', 'native_solvers']
