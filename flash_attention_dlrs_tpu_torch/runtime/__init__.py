from .data import LoaderState, TokenDataset, batches
from .engine import DecodeEngine, StreamEvent
from .kv_cache import PageAllocator
from .sampling import GREEDY, SamplingParams
from .scheduler import ContinuousBatchingScheduler, Request, RequestState

__all__ = [
    "DecodeEngine",
    "LoaderState",
    "TokenDataset",
    "batches",
    "StreamEvent",
    "PageAllocator",
    "GREEDY",
    "SamplingParams",
    "ContinuousBatchingScheduler",
    "Request",
    "RequestState",
]
