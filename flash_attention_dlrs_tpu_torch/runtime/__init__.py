from .data import LoaderState, TokenDataset, batches
from .engine import DecodeEngine, StreamEvent
from .kv_cache import PageAllocator, PagedKVCache
from .prefix_cache import PrefixCache
from .sampling import GREEDY, SamplingParams
from .scheduler import ContinuousBatchingScheduler, Request, RequestState

__all__ = [
    "DecodeEngine",
    "LoaderState",
    "TokenDataset",
    "batches",
    "StreamEvent",
    "PageAllocator",
    "PagedKVCache",
    "PrefixCache",
    "GREEDY",
    "SamplingParams",
    "ContinuousBatchingScheduler",
    "Request",
    "RequestState",
]
