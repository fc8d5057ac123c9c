"""Graph algorithms behind the optimization passes."""

from .blocks import BlockBuilder, TrainableBlock
from .equalization import (EqualizationHelper, EqualizationPair,
                           find_equalization_pairs)

__all__ = ['BlockBuilder', 'TrainableBlock', 'EqualizationHelper',
           'EqualizationPair', 'find_equalization_pairs']
