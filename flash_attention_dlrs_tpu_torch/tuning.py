"""Tile tuner: enumerate → prune by the shared-memory model → (optionally) time.

The port of ``flash_attention_dlrs_tpu/tuning.py``, itself a rebuild of the
reference autotuner (``src/autotune_configs.py:24-140`` enumerates Triton
configurations, ``:169-245`` prunes them against a GA102 SRAM model, and
``triton.autotune`` times the survivors, cached per (B, H, N, d) key).  Here
the candidates are the tiles the Hopper kernels are built with: the key
tile of the forward (``block_kv``: 128 keys, and 64 from
``csrc/attn_fwd_tiles.cu``; 64 only at d 256) and the rows the backward
sweeps stream a stage (``block_kv_bwd``: 64, and 32 from
``csrc/attn_bwd_tiles.cu``; 32 only at d 256, where it sets the dQ sweep's
keys and the dK/dV sweep streams 64 q rows of its one layout).  A CTA owns
128 q rows in the forward (two consumer warpgroups) and 128 resident rows
in the sweeps (64 keys in the d 256 dK/dV sweep), so ``block_q`` and
``block_q_bwd`` are 128.  The other tiles are built
without ALiBi, dropout, segment ids or fp8 V: a call with one of those has
its build's own tile as its only candidate.  Candidates are pruned by
:mod:`.geometry`'s byte-exact model of the kernels' shared memory, and the
timed search (``tune=True``) is cached in process and on disk, keyed by the
card's name and the call's shape.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import time
from typing import Optional

import torch

from . import geometry as geo

# The forward's key tiles and the sweeps' streamed tiles that some build
# carries, by head dim (csrc/attn_fwd{,_d64,_d256}.cu and attn_fwd_tiles.cu;
# csrc/attn_bwd{,_d64,_d256}.cu and attn_bwd_tiles.cu), each head dim's own
# tile first.  block_kv_bwd sets both sweeps' streamed rows at d 64 and 128
# and the dQ sweep's keys at d 256, whose dK/dV sweep always streams
# geometry.D256_DKV_ROWS q rows (geometry.bwd_stream_rows).
BUILT_BLOCK_KV = {64: (128, 64), 128: (128, 64), 256: (64,)}
BUILT_BLOCK_KV_BWD = {64: (64, 32), 128: (64, 32), 256: (32,)}
# The wide builds' tiles (csrc/wide.cuh, every head dim above 256 that is a
# multiple of 128): to 1024 32 keys a forward tile and 32 rows a sweep's
# stream (the 16-bit kernels on wide_wgmma); above it (geometry.chunked)
# the one tile of route wide_scores' passes, in every mode: score tiles of
# 128 keys and product passes streaming 64 rows a stage.
WIDE_BLOCK_KV = (geo.WIDE_FWD_KEYS,)
WIDE_BLOCK_KV_BWD = (geo.WIDE_BWD_ROWS,)
CHUNK_BLOCK_KV = (geo.WIDE_SCORES_TILE,)
CHUNK_BLOCK_KV_BWD = (geo.WIDE_SCORES_ROWS,)
CTA_ROWS = geo.CTA_ROWS


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tiles of the attention kernels (the forward and both backward
    sweeps), the JAX package's four fields on Hopper's tiles: ``block_q``
    and ``block_q_bwd`` are a CTA's 128 rows; ``block_kv`` is 64 or 128
    (64 at head dim 256, 32 at the wide head dims to 1024, above them 128,
    the score tiles' keys of route ``"wide_scores"``), ``block_kv_bwd`` 32
    or 64 (32 at d 256 and at the wide head dims to 1024, 64 above: the
    rows a product pass streams): the rows both sweeps stream
    a stage, but at d 256 the dQ sweep's keys only (the dK/dV sweep streams
    64 q rows there, :func:`..geometry.bwd_stream_rows`).  The head dim is checked
    when a call uses the tiles (:meth:`check`)."""

    block_q: int = CTA_ROWS
    block_kv: int = 128
    block_q_bwd: int = CTA_ROWS
    block_kv_bwd: int = 64

    def __post_init__(self):
        for name in ("block_q", "block_q_bwd"):
            if getattr(self, name) != CTA_ROWS:
                raise ValueError(
                    f"{name}={getattr(self, name)}: a Hopper CTA owns {CTA_ROWS} rows "
                    f"(two consumer warpgroups of 64)")
        if self.block_kv not in (32, 64, 128):
            raise ValueError(f"block_kv={self.block_kv} must be 32, 64 or 128")
        if self.block_kv_bwd not in (32, 64):
            raise ValueError(f"block_kv_bwd={self.block_kv_bwd} must be 32 or 64")

    def check(self, head_dim: int, *, alibi: bool = False, dropout: bool = False,
              segments: bool = False, fp8_v: bool = False) -> None:
        """Raise ``ValueError`` unless some build carries these tiles at
        ``head_dim`` (the kernels' width: 64, 128, 256 or a wide width, whose
        one build carries block_kv 32 and block_kv_bwd 32 in every mode and
        cuts its own 64-row CTAs, or above 1024 the passes of route
        "wide_scores", 128 and 64) with the call's modes; the message names
        the built tiles."""
        modes = alibi or dropout or segments or fp8_v
        fwd = built_fwd_tiles(head_dim, modes)
        bwd = built_bwd_tiles(head_dim, modes)
        if self.block_kv not in fwd or self.block_kv_bwd not in bwd:
            what = " with ALiBi, dropout, segment ids or fp8 V" if modes else ""
            if geo.chunked(head_dim):
                what = " (the score and product passes of csrc/wide_scores.cuh)"
            elif geo.is_wide(head_dim):
                what = " (the wide build, csrc/wide.cuh)"
            raise ValueError(
                f"{self}: the kernels at head dim {head_dim}{what} are built with "
                f"block_kv in {fwd} and block_kv_bwd in {bwd}")


def built_fwd_tiles(head_dim: int, modes: bool = False) -> tuple:
    """The forward's key tiles built at ``head_dim``: the build's own only
    with a mode (ALiBi, dropout, segment ids, fp8 V).  The wide head dims
    (:func:`..geometry.is_wide`) have the wide build's one tile (above 1024
    the passes' of route "wide_scores", :func:`..geometry.chunked`); other head
    dims (the plain versions only) take the d 128 tiles."""
    if geo.chunked(head_dim):
        return CHUNK_BLOCK_KV
    if geo.is_wide(head_dim):
        return WIDE_BLOCK_KV
    tiles = BUILT_BLOCK_KV.get(head_dim, BUILT_BLOCK_KV[128])
    return tiles[:1] if modes else tiles


def built_bwd_tiles(head_dim: int, modes: bool = False) -> tuple:
    """The sweeps' streamed tiles built at ``head_dim``, as
    :func:`built_fwd_tiles`."""
    if geo.chunked(head_dim):
        return CHUNK_BLOCK_KV_BWD
    if geo.is_wide(head_dim):
        return WIDE_BLOCK_KV_BWD
    tiles = BUILT_BLOCK_KV_BWD.get(head_dim, BUILT_BLOCK_KV_BWD[128])
    return tiles[:1] if modes else tiles


def candidate_fwd_configs(head_dim: int, *, segments: bool = False, fp8_v: bool = False,
                          alibi: bool = False, dropout: bool = False,
                          geom: Optional[geo.HopperGeometry] = None) -> list:
    """(block_q, block_kv) candidates of a forward call: every key tile the
    kernels are built with for the call's head dim and modes, pruned by the
    shared-memory model (a tile whose ring has no stage that fits is out:
    at d 256, 128-key tiles need 65,536 + 2·2·65,536 bytes, past 232,448),
    as the reference pruned its configurations by its SRAM model."""
    if geo.is_wide(head_dim):  # one tile, whose layout needs no head row
        return [(CTA_ROWS, bkv) for bkv in built_fwd_tiles(head_dim)]
    geom = geom or geo.current_geometry("cpu")
    modes = alibi or dropout or segments or fp8_v
    out = []
    for bkv in (128, 64):
        stages = geo.fwd_stages(bkv, head_dim, segments, fp8_v, geom)
        if stages and bkv in built_fwd_tiles(head_dim, modes) and geo.fits_smem(
                geo.attention_fwd_smem_bytes(bkv, head_dim, stages, segments, fp8_v), geom):
            out.append((CTA_ROWS, bkv))
    return out


def candidate_bwd_configs(head_dim: int, *, segments: bool = False, alibi: bool = False,
                          dropout: bool = False,
                          geom: Optional[geo.HopperGeometry] = None) -> list:
    """(block_q_bwd, block_kv_bwd) candidates of a backward call: the
    streamed tiles built for its head dim and modes whose dK/dV and dQ
    layouts both fit."""
    if geo.is_wide(head_dim):
        return [(CTA_ROWS, bs) for bs in built_bwd_tiles(head_dim)]
    geom = geom or geo.current_geometry("cpu")
    modes = alibi or dropout or segments
    out = []
    for bs in (64, 32):
        fits = all(geo.fits_smem(geo.attention_bwd_smem_bytes(bs, head_dim, segments, dkv), geom)
                   for dkv in (True, False))
        if fits and bs in built_bwd_tiles(head_dim, modes):
            out.append((CTA_ROWS, bs))
    return out


def default_block_sizes(head_dim: int) -> BlockSizes:
    """The tiles every call takes unless told otherwise: each head dim's own
    builds', (128, 128, 128, 64), (128, 64, 128, 32) at d 256, (128, 32,
    128, 32) in the wide builds to 1024 and (128, 128, 128, 64) above."""
    width = head_dim if head_dim in BUILT_BLOCK_KV or geo.is_wide(head_dim) else 128
    return BlockSizes(block_kv=geo.default_block_kv(width),
                      block_kv_bwd=geo.default_block_kv_bwd(width))


# ---------------------------------------------------------------------------
# Timed search (explicit opt-in), cached per shape key like Triton's
# per-(B, H, N, d) autotune cache (reference flash_attention_kernels.py:13).
# ---------------------------------------------------------------------------

_TUNE_CACHE: dict = {}
_CACHE_PATH = os.path.join(
    os.path.expanduser(os.environ.get("FA_TORCH_CACHE_DIR", "~/.cache/fa_torch")),
    "tune_cache.json",
)
# Every candidate time of the searches this process ran, by cache key:
# {key: [[candidate, seconds or None], ...]} (None: skipped, did not fit).
TIMINGS: dict = {}


def _load_disk_cache() -> dict:
    try:
        with open(_CACHE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_disk_cache(cache: dict) -> None:
    try:
        os.makedirs(os.path.dirname(_CACHE_PATH), exist_ok=True)
        with open(_CACHE_PATH, "w") as f:
            json.dump(cache, f)
    except OSError:
        pass


# CUDA's failures of a candidate that does not FIT the card: a launch that
# asks for more registers or threads than an SM has
# (cudaErrorLaunchOutOfResources), a shared-memory request past the opt-in
# ("out of resource: shared memory"), memory exhausted.  Only these are
# skipped; any other error is a fault of a kernel route and propagates (see
# _tune_cached).  A refused shared-memory attribute comes back as
# cudaErrorInvalidValue, the code of any refused argument, so the layouts
# that could not get one are pruned before timing (candidate_*_configs).
_RESOURCE_ERROR_MARKERS = (
    "too many resources requested for launch",
    "cudaerrorlaunchoutofresources",
    "out of resource",
    "out of memory",
    "cudaerrormemoryallocation",
)


def _is_resource_error(e: Exception) -> bool:
    """True iff the exception reports the candidate not FITTING the card
    (launch resources, the shared-memory opt-in, memory) — the only failure
    the timed search may skip."""
    msg = f"{type(e).__name__}: {e}".lower()
    return isinstance(e, torch.cuda.OutOfMemoryError) or any(
        m in msg for m in _RESOURCE_ERROR_MARKERS)


def _time_call(fn, *args, warmup: int = 2, reps: int = 5, graph: bool = False) -> float:
    """Median time of ``fn(*args)`` in seconds: CUDA events around each call
    on the card (synchronised), the host clock for CPU inputs.  With
    ``graph`` the card times replays of one call captured as a CUDA graph
    (after the warm-up, on a side stream), so the call's host time stays
    out of a short kernel's reading: its device time."""
    device = next((a.device for a in args if torch.is_tensor(a)), torch.device("cpu"))
    run = functools.partial(fn, *args)
    if graph and device.type == "cuda":
        side = torch.cuda.Stream(device)  # a capture's warm-up runs off the capture
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                run()
        torch.cuda.current_stream(device).wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()
    else:
        for _ in range(warmup):
            run()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _device_name(args) -> str:
    device = next((a.device for a in args if torch.is_tensor(a)), torch.device("cpu"))
    return geo.current_geometry(device).device_name if device.type == "cuda" else "cpu"


def _tune_cached(key_parts, candidates, build_fn, args, graph: bool = False):
    """Time ``build_fn(*cand)(*args)`` for each candidate (``cand`` a tuple,
    else ``build_fn(cand)``; ``graph``: as CUDA graph replays,
    :func:`_time_call`), cache the fastest on the JSON key (the card's
    name, then ``key_parts``) in process and on disk, and return it.  A
    candidate that does not fit the card is skipped; any other failure
    raises ``RuntimeError``."""
    key = json.dumps([_device_name(args), *key_parts])
    if not _TUNE_CACHE:
        _TUNE_CACHE.update(_load_disk_cache())
    if key in _TUNE_CACHE:
        v = _TUNE_CACHE[key]
        return tuple(v) if isinstance(v, list) else v
    best, best_t = candidates[0], float("inf")
    timings = TIMINGS.setdefault(key, [])
    for cand in candidates:
        try:
            fn = build_fn(*cand) if isinstance(cand, tuple) else build_fn(cand)
            t = _time_call(fn, *args, graph=True) if graph else _time_call(fn, *args)
        except Exception as e:  # noqa: BLE001 — classified below
            if _is_resource_error(e):
                timings.append([cand, None])
                continue  # the candidate does not fit: skip it
            raise RuntimeError(
                f"tuning candidate {cand!r} for key {key_parts!r} failed "
                f"with a non-resource error: {type(e).__name__}: {e}"
            ) from e
        timings.append([cand, t])
        if t < best_t:
            best, best_t = cand, t
    _TUNE_CACHE[key] = list(best) if isinstance(best, tuple) else best
    _save_disk_cache(_TUNE_CACHE)
    return best


def tune_fwd_blocks(build_fn, q, k, v, *, candidates=None, key_extra=None) -> tuple:
    """Time the forward's (block_q, block_kv) candidates and cache the
    fastest on the (q shape, k shape, dtype, ``key_extra``) key.
    ``build_fn(block_q, block_kv)`` returns a callable of (q, k, v);
    ``candidates`` default to :func:`candidate_fwd_configs` of q's head
    dim."""
    cands = candidates or candidate_fwd_configs(q.shape[-1])
    return _tune_cached(
        ["fwd", list(q.shape), list(k.shape), str(q.dtype), key_extra],
        cands, build_fn, (q, k, v),
    )


def tune_bwd_blocks(build_fn, q, k, v, do, *, candidates=None, key_extra=None) -> tuple:
    """Time the backward's (block_q_bwd, block_kv_bwd) candidates and cache
    the fastest, as :func:`tune_fwd_blocks`; ``build_fn(bq, bkv)`` returns a
    callable of (q, k, v, do) that runs the backward and consumes all three
    gradients."""
    cands = candidates or candidate_bwd_configs(q.shape[-1])
    return _tune_cached(
        ["bwd", list(q.shape), list(k.shape), str(q.dtype), key_extra],
        cands, build_fn, (q, k, v, do),
    )


def tune_decode_pages_per_block(build_fn, candidates, key_parts, args):
    """Time paged ``pages_per_block`` candidates (pages per key split of
    paged decode and verify) by device time (CUDA graph replays on the
    card) and cache the fastest on the given key.  ``build_fn(ppb)``
    returns a callable taking ``args``."""
    return _tune_cached(["decode", *key_parts], list(candidates), build_fn, args,
                        graph=True)
