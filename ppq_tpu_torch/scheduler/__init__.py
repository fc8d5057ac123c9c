from .base import GraphDispatcher, soi_generators, soi_receivers
from .dispatchers import (AggressiveDispatcher, AllinDispatcher,
                          ConservativeDispatcher, PerseusDispatcher,
                          PointDispatcher, PPLNNDispatcher)

# reference: ppq/scheduler/__init__.py:8-15 DISPATCHER_TABLE
DISPATCHER_TABLE = {
    'conservative': ConservativeDispatcher,
    'aggressive':   AggressiveDispatcher,
    'aggresive':    AggressiveDispatcher,   # reference spelling kept as alias
    'pointwise':    PointDispatcher,
    'allin':        AllinDispatcher,
    'perseus':      PerseusDispatcher,
    'pplnn':        PPLNNDispatcher,
}


def register_dispatcher(name: str, dispatcher_cls):
    """(reference: user extension point for DISPATCHER_TABLE)"""
    DISPATCHER_TABLE[name.lower()] = dispatcher_cls

__all__ = [
    'GraphDispatcher', 'DISPATCHER_TABLE', 'ConservativeDispatcher',
    'AggressiveDispatcher', 'AllinDispatcher', 'PointDispatcher',
    'PerseusDispatcher', 'PPLNNDispatcher', 'soi_generators',
    'soi_receivers',
]
