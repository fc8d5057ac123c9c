"""Graph algorithms behind the optimization passes."""

from .blocks import BlockBuilder, TrainableBlock

__all__ = ['BlockBuilder', 'TrainableBlock']
