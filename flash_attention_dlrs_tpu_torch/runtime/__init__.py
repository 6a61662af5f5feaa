from .data import LoaderState, TokenDataset, batches
from .engine import DecodeEngine, StreamEvent
from .kv_cache import PageAllocator, PagedKVCache
from .native_alloc import NativePageAllocator, make_page_allocator
from .native_data import NativeTokenLoader, native_batches
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
    "NativePageAllocator",
    "make_page_allocator",
    "NativeTokenLoader",
    "native_batches",
    "PrefixCache",
    "GREEDY",
    "SamplingParams",
    "ContinuousBatchingScheduler",
    "Request",
    "RequestState",
]
