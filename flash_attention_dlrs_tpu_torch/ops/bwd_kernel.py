"""Attention backward kernels: wrappers, plain version and launch counts.

The kernels are ``csrc/attn_bwd.cuh`` (the D preprocess, the fp32 sweeps
and the C entries) and ``csrc/attn_bwd_sm90.cuh`` (the bf16 / fp16 sweeps):
``attn_bwd_preprocess`` (D = rowsum(O ∘ dO), any head dim), ``attn_bwd_dkv``
and ``attn_bwd_dq``, the two sweeps built six times, once for each head dim
without and with segment ids (:func:`sweep_kernel`): ``csrc/attn_bwd.cu``
(head dim 128, with the preprocess), ``csrc/attn_bwd_seg.cu``
(``attn_bwd_dkv_seg``, ``attn_bwd_dq_seg``), ``csrc/attn_bwd_d64.cu`` /
``attn_bwd_d64_seg.cu`` and ``csrc/attn_bwd_d256.cu`` /
``attn_bwd_d256_seg.cu`` (entries suffixed alike), each entry with its own
launch count; a seventh, ``csrc/attn_bwd_tiles.cu`` (``attn_bwd_dkv_tiles``,
``attn_bwd_dq_tiles``), carries the 32-row stages at d 64 and 128 that a
caller may pin or the tuner pick (``block_sizes``, :mod:`..tuning`),
mode-free; an eighth, ``csrc/attn_bwd_wide.cu`` (``attn_bwd_dkv_wide``,
``attn_bwd_dq_wide``: the sweeps of ``csrc/wide.cuh``),
every head dim above 256 that is a multiple of 128, with every mode, but
the bf16 / fp16 ones above 1024, which take the score pass and the product
passes of ``csrc/wide_scores.cuh`` (:mod:`.wide_scores`, built as
``csrc/attn_bwd_scores.cu``).  Each sweep call takes one of six routes,
fixed by :func:`bwd_route` from the call's types and width alone and
counted per sweep in
:data:`BWD_ROUTE_LAUNCHES`: ``"wgmma"`` (the Hopper kernels: warpgroup
products, TMA, a producer warpgroup; every bf16/fp16 call at d 64, 128 and
256), ``"fp32"`` (CUDA cores, true fp32), and at the wide head dims
``"wide_wgmma"`` (bf16/fp16 to 1024: owners of 128 or 256 columns computing
S and dP once a tile, a cluster of CTAs; the forward's route code),
``"wide_scores"`` (bf16/fp16 above 1024: one score pass computes S and dP
once a tile and stores P∘M and dS, then a dK / dV and a dQ product pass)
and ``"wide_fp32"``.
The C entries refuse a route that cannot carry a call; nothing switches
routes at run time.  Together they replace the six backward TPU kernels of
the JAX package — ``ops/fwd_small.py::_small_bwd_kernel``,
``ops/bwd_kernel.py::_bwd_d_kernel``, ``_bwd_dkv_kernel`` and
``_bwd_dq_kernel``, ``ops/bwd_fused.py::_bwd_fused_kernel`` and
``ops/bwd_mid.py::_bwd_mid_kernel`` — for the forward's feature set (causal
or not, GQA, ragged lengths, window, softcap, ALiBi, attention dropout,
segment ids; fp8 V has no backward, as in the JAX package).  Dropout
regenerates the forward's mask from the same seed: dV = (P∘M)ᵀdO and
dS = P∘(M∘dP − D), with D = rowsum(dO∘O) unchanged.  The result is
deterministic: every sum runs in a fixed order and no kernel uses atomics.
:func:`attn_bwd` sends CPU tensors to the plain PyTorch version
:func:`attn_bwd_plain` and CUDA tensors to the kernels; each kernel's
wrapper likewise has a plain version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from .._cuda import DTYPE_CODES, CudaKernel, ptr, register_launch_counts, stream_handle
from ..geometry import bwd_stream_rows, chunked, default_block_kv_bwd, is_wide
from . import wide_scores
from .fwd_kernel import (
    _PLAIN_CHUNK_ELEMS,
    KERNEL_WIDTHS,
    MOD_ARGS,
    ROUTE_CODES,
    _row_bias,
    bias_and_mask,
    check_kernel_head_dim,
    check_segments,
    dropout_rows,
    mod_args,
)

# The head dims the backward kernels are built for (the forward's), each
# with every mode; 256 in builds of its own, and the wide head dims (above
# 256, every multiple of 128) in attn_bwd_wide.cu.
BWD_HEAD_DIMS = KERNEL_WIDTHS

PREPROCESS_KERNEL = CudaKernel(
    "attn_bwd.cu",
    "attn_bwd_preprocess",
    [ctypes.c_void_p] * 3  # o, dout, delta
    + [ctypes.c_int] * 3  # dtype, rows, D
    + [ctypes.c_void_p],  # stream
)
_SWEEP_ARGS = (
    [ctypes.c_int] * 6  # dtype, B, Hq, Hkv, Nq, Nkv
    + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + MOD_ARGS
    + [ctypes.c_int]  # route
    + [ctypes.c_void_p]  # stream
)
# q, k, v, dout, lse, delta, dk, dv, q_seg, kv_seg
_DKV_ARGS = [ctypes.c_void_p] * 10 + _SWEEP_ARGS
# q, k, v, dout, lse, delta, dq, q_seg, kv_seg
_DQ_ARGS = [ctypes.c_void_p] * 9 + _SWEEP_ARGS
DKV_KERNEL = CudaKernel("attn_bwd.cu", "attn_bwd_dkv", _DKV_ARGS)
DQ_KERNEL = CudaKernel("attn_bwd.cu", "attn_bwd_dq", _DQ_ARGS)
DKV_SEG_KERNEL = CudaKernel("attn_bwd_seg.cu", "attn_bwd_dkv_seg", _DKV_ARGS)
DQ_SEG_KERNEL = CudaKernel("attn_bwd_seg.cu", "attn_bwd_dq_seg", _DQ_ARGS)
DKV_D64_KERNEL = CudaKernel("attn_bwd_d64.cu", "attn_bwd_dkv_d64", _DKV_ARGS)
DQ_D64_KERNEL = CudaKernel("attn_bwd_d64.cu", "attn_bwd_dq_d64", _DQ_ARGS)
DKV_D64_SEG_KERNEL = CudaKernel("attn_bwd_d64_seg.cu", "attn_bwd_dkv_d64_seg", _DKV_ARGS)
DQ_D64_SEG_KERNEL = CudaKernel("attn_bwd_d64_seg.cu", "attn_bwd_dq_d64_seg", _DQ_ARGS)
DKV_D256_KERNEL = CudaKernel("attn_bwd_d256.cu", "attn_bwd_dkv_d256", _DKV_ARGS)
DQ_D256_KERNEL = CudaKernel("attn_bwd_d256.cu", "attn_bwd_dq_d256", _DQ_ARGS)
DKV_D256_SEG_KERNEL = CudaKernel("attn_bwd_d256_seg.cu", "attn_bwd_dkv_d256_seg", _DKV_ARGS)
DQ_D256_SEG_KERNEL = CudaKernel("attn_bwd_d256_seg.cu", "attn_bwd_dq_d256_seg", _DQ_ARGS)
# The other streamed tiles (csrc/attn_bwd_tiles.cu): the builds' arguments
# with the tile's rows before the route.
DKV_TILES_KERNEL = CudaKernel("attn_bwd_tiles.cu", "attn_bwd_dkv_tiles",
                              _DKV_ARGS[:-2] + [ctypes.c_int] + _DKV_ARGS[-2:])
DQ_TILES_KERNEL = CudaKernel("attn_bwd_tiles.cu", "attn_bwd_dq_tiles",
                             _DQ_ARGS[:-2] + [ctypes.c_int] + _DQ_ARGS[-2:])
# Every head dim above 256 (csrc/attn_bwd_wide.cu): the builds' arguments.
DKV_WIDE_KERNEL = CudaKernel("attn_bwd_wide.cu", "attn_bwd_dkv_wide", _DKV_ARGS)
DQ_WIDE_KERNEL = CudaKernel("attn_bwd_wide.cu", "attn_bwd_dq_wide", _DQ_ARGS)
# The launches of each sweep on each route (the C entries' route codes are
# the forward's, ops/fwd_kernel.py ROUTE_CODES), over the six builds; set
# to 0 by whoever reads them.
BWD_ROUTE_LAUNCHES = {sweep: register_launch_counts(dict.fromkeys(ROUTE_CODES, 0))
                      for sweep in ("attn_bwd_dkv", "attn_bwd_dq")}
# Each sweep's wgmma and wide_wgmma launches by head dim and the rows it
# streamed a stage ("d128_kv32", "d512_kv32"; the d 256 dK/dV sweep
# "d256_kv64", geometry.bwd_stream_rows), over every build; set to 0 by
# whoever reads them.
BWD_TILE_LAUNCHES = {sweep: register_launch_counts({})
                     for sweep in ("attn_bwd_dkv", "attn_bwd_dq")}


def bwd_route(dtype, head_dim: int, segments: bool = False, alibi: bool = False,
              dropout: bool = False) -> str:
    """The kernel route of a backward sweep call, from its types alone:

    =========  =========================================================
    route      calls
    =========  =========================================================
    fp32       q in float32 (CUDA cores, true fp32; with or without
               segment ids)
    wgmma      bf16 / fp16 q, with or without segment ids
    wide_fp32  as fp32, at a wide head dim (``csrc/wide.cuh``)
    wide_wgmma as wgmma, at a wide head dim up to 1024 (``csrc/wide.cuh``
               ``wide_bwd_dkv_kernel`` / ``wide_bwd_dq_kernel``)
    wide_scores as wgmma, at a wide head dim above 1024
               (``csrc/wide_scores.cuh``: the backward score pass, then the
               dK / dV or dQ product pass, :mod:`.wide_scores`)
    =========  =========================================================

    Segment ids, ALiBi and dropout are modes of every route at every head
    dim and change none (the mode arguments are kept so that a caller can
    name what it runs).  d must be 64, 128, 256 or a multiple of 128 above
    256; anything else raises."""
    del segments, alibi, dropout
    check_kernel_head_dim(head_dim, "attn_bwd kernels", BWD_HEAD_DIMS)
    wide = is_wide(head_dim)
    if dtype == torch.float32:
        return "wide_fp32" if wide else "fp32"
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"attn_bwd kernels take fp32/bf16/fp16, not {dtype}")
    if chunked(head_dim):
        return "wide_scores"
    return "wide_wgmma" if wide else "wgmma"


def _check_cuda(q, k, v, o, lse, do) -> None:
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.data_ptr() % 16:  # 16-byte loads and TMA tensor maps
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"attn_bwd kernels take fp32/bf16/fp16, not {q.dtype}")
    check_kernel_head_dim(q.shape[-1], "attn_bwd kernels", BWD_HEAD_DIMS)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(
            f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse {tuple(lse.shape)} "
            f"do not match q {tuple(q.shape)}")


def attn_bwd_preprocess(o, do):
    """D = rowsum(O ∘ dO), [B, Hq, Nq] fp32: the preprocess kernel on a CUDA
    device, :func:`attn_bwd_preprocess_plain` on the CPU."""
    if o.device.type == "cpu":
        return attn_bwd_preprocess_plain(o, do)
    delta = torch.empty(o.shape[:3], dtype=torch.float32, device=o.device)
    PREPROCESS_KERNEL.launch(
        ptr(o), ptr(do), ptr(delta), DTYPE_CODES[o.dtype],
        o.numel() // o.shape[-1], o.shape[-1], stream_handle(o.device))
    return delta


def _sweep_args(q, k, route, tile, causal, sm_scale, window, softcap, alibi_slopes,
                dropout_rate, dropout_seed, q_seg, kv_seg, block_sizes):
    del block_sizes  # the tile, resolved by _stream_tile
    b, hq, n_q, d = q.shape
    extra = [] if tile == default_block_kv_bwd(d) else [tile]
    return (ptr(q_seg), ptr(kv_seg), DTYPE_CODES[q.dtype], b, hq, k.shape[1], n_q,
            k.shape[2], d, float(sm_scale), int(bool(causal)), int(window),
            float(softcap), *mod_args(alibi_slopes, dropout_rate, dropout_seed, q.device),
            *extra, ROUTE_CODES[route], stream_handle(q.device))


def _kw(causal, sm_scale, window, softcap, alibi_slopes, dropout_rate,
        dropout_seed, q_seg, kv_seg, block_sizes=None):
    return dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap,
                alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
                dropout_seed=dropout_seed, q_seg=q_seg, kv_seg=kv_seg,
                block_sizes=block_sizes)


def _route(q, *, alibi_slopes, dropout_rate, q_seg, **_):
    """:func:`bwd_route` of a sweep call on q."""
    return bwd_route(q.dtype, q.shape[-1], q_seg is not None, alibi_slopes is not None,
                     bool(dropout_rate))


def _stream_tile(q, route, *, alibi_slopes, dropout_rate, q_seg, block_sizes, **_):
    """Rows the call's sweeps stream a stage: ``block_sizes.block_kv_bwd``
    on the wgmma route if a build carries the tiles at q's head dim with the
    call's modes (``BlockSizes.check``: ``ValueError`` naming the built
    tiles otherwise), the head dim's own tile without ``block_sizes`` or on
    the fp32 route (its own fixed steps)."""
    d = q.shape[-1]
    if route not in ("wgmma", "wide_wgmma", "wide_scores") or block_sizes is None:
        return default_block_kv_bwd(d)
    block_sizes.check(d, alibi=alibi_slopes is not None, dropout=bool(dropout_rate),
                      segments=q_seg is not None)
    return block_sizes.block_kv_bwd


def sweep_kernel(sweep: str, head_dim: int, segments: bool, block_kv_bwd=None) -> CudaKernel:
    """The build of ``sweep`` ("attn_bwd_dkv" or "attn_bwd_dq") that takes a
    call, by head dim and by whether it has segment ids: the module
    attribute ``DKV[_D<d>][_SEG]_KERNEL`` / ``DQ...`` (no suffix at d 128),
    ``DKV_WIDE_KERNEL`` / ``DQ_WIDE_KERNEL`` at a wide head dim (above 1024
    the fp32 route's; bf16 / fp16 there take :mod:`.wide_scores`' passes), or
    ``DKV_TILES_KERNEL`` / ``DQ_TILES_KERNEL`` for a ``block_kv_bwd``
    other than the head dim's own, looked up at call time so that a check
    may swap a build."""
    name = "DKV" if sweep == "attn_bwd_dkv" else "DQ"
    if is_wide(head_dim):
        return globals()[f"{name}_WIDE_KERNEL"]
    if block_kv_bwd not in (None, default_block_kv_bwd(head_dim)):
        return globals()[f"{name}_TILES_KERNEL"]
    dim = "" if head_dim == 128 else f"_D{head_dim}"
    return globals()[f"{name}{dim}{'_SEG' if segments else ''}_KERNEL"]


def _count(sweep, route, d, tile) -> None:
    BWD_ROUTE_LAUNCHES[sweep][route] += 1
    if route in ("wgmma", "wide_wgmma"):
        key = f"d{d}_kv{bwd_stream_rows(d, tile, sweep == 'attn_bwd_dkv')}"
        BWD_TILE_LAUNCHES[sweep][key] = BWD_TILE_LAUNCHES[sweep].get(key, 0) + 1


def attn_bwd_dkv(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                 softcap=0.0, alibi_slopes=None, dropout_rate=0.0, dropout_seed=0,
                 q_seg=None, kv_seg=None, block_sizes=None):
    """(dK, dV) [B, Hkv, Nkv, d] in k's dtype: the dK/dV sweep kernel on the
    route of :func:`bwd_route` on a CUDA device (its segment build with
    ``q_seg`` / ``kv_seg``, streaming ``block_sizes.block_kv_bwd`` q rows a
    stage, 64 at d 256: :func:`_stream_tile`), :func:`attn_bwd_dkv_plain` on
    the CPU."""
    kw = _kw(causal, sm_scale, window, softcap, alibi_slopes, dropout_rate,
             dropout_seed, q_seg, kv_seg, block_sizes)
    if q.device.type == "cpu":
        return attn_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    route = _route(q, **kw)
    tile = _stream_tile(q, route, **kw)
    if route == "wide_scores":
        del kw["block_sizes"]
        out = wide_scores.attn_bwd_scores(q, k, v, do, lse, delta, sweeps=("dkv",), **kw)
        _count("attn_bwd_dkv", route, q.shape[-1], tile)
        return out["dk"], out["dv"]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel = sweep_kernel("attn_bwd_dkv", q.shape[-1], q_seg is not None, tile)
    kernel.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                  ptr(dk), ptr(dv), *_sweep_args(q, k, route, tile, **kw))
    _count("attn_bwd_dkv", route, q.shape[-1], tile)
    return dk, dv


def attn_bwd_dq(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                softcap=0.0, alibi_slopes=None, dropout_rate=0.0, dropout_seed=0,
                q_seg=None, kv_seg=None, block_sizes=None):
    """dQ [B, Hq, Nq, d] in q's dtype: the dQ sweep kernel on the route of
    :func:`bwd_route` on a CUDA device (its segment build with ``q_seg`` /
    ``kv_seg``, streaming ``block_sizes.block_kv_bwd`` keys a stage),
    :func:`attn_bwd_dq_plain` on the CPU."""
    kw = _kw(causal, sm_scale, window, softcap, alibi_slopes, dropout_rate,
             dropout_seed, q_seg, kv_seg, block_sizes)
    if q.device.type == "cpu":
        return attn_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    route = _route(q, **kw)
    tile = _stream_tile(q, route, **kw)
    if route == "wide_scores":
        del kw["block_sizes"]
        out = wide_scores.attn_bwd_scores(q, k, v, do, lse, delta, sweeps=("dq",), **kw)
        _count("attn_bwd_dq", route, q.shape[-1], tile)
        return out["dq"]
    dq = torch.empty_like(q)
    kernel = sweep_kernel("attn_bwd_dq", q.shape[-1], q_seg is not None, tile)
    kernel.launch(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
                  ptr(dq), *_sweep_args(q, k, route, tile, **kw))
    _count("attn_bwd_dq", route, q.shape[-1], tile)
    return dq


def attn_bwd(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
             window: int = 0, softcap: float = 0.0, alibi_slopes=None,
             dropout_rate: float = 0.0, dropout_seed: int = 0, q_seg=None,
             kv_seg=None, block_sizes=None):
    """(dQ, dK, dV) of O = dropout(softmax(scale·QKᵀ (softcapped) + ALiBi
    bias + mask))V, given the forward's O and natural-base lse [B, Hq, Nq]
    and the output gradient dO; ALiBi, dropout and segment arguments as in
    :func:`..fwd_kernel.attn_fwd`, matching the forward's.

    Arguments are validated by the caller (ops/flash_attention.py).  CPU
    tensors take :func:`attn_bwd_plain`; CUDA tensors launch the three
    kernels (preprocess, dK/dV sweep, dQ sweep; on route ``"wide_scores"``
    the preprocess, one score pass and the two product passes a wave,
    :func:`.wide_scores.attn_bwd_scores`; the sweeps on the route of
    :func:`bwd_route`, streaming ``block_sizes.block_kv_bwd`` rows a stage:
    a tile no build carries for the call raises ``ValueError`` before any
    launch), which take contiguous fp32/bf16/fp16 inputs with d in {64,
    128, 256} or a multiple of 128 above 256, or raise."""
    kw = _kw(causal, sm_scale, window, softcap, alibi_slopes, dropout_rate,
             dropout_seed, q_seg, kv_seg, block_sizes)
    if q.device.type == "cpu":
        return attn_bwd_plain(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"attn_bwd runs on cpu or cuda, not {q.device}")
    _check_cuda(q, k, v, o, lse, do)
    check_segments(q, k, q_seg, kv_seg)
    route = _route(q, **kw)
    tile = _stream_tile(q, route, **kw)  # a tile no build carries raises first
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    delta = attn_bwd_preprocess(o, do)
    if route == "wide_scores":  # one score pass for both products
        del kw["block_sizes"]
        out = wide_scores.attn_bwd_scores(q, k, v, do, lse, delta, **kw)
        _count("attn_bwd_dkv", route, q.shape[-1], tile)
        _count("attn_bwd_dq", route, q.shape[-1], tile)
        return out["dq"], out["dk"], out["dv"]
    dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return attn_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv


# ---------------------------------------------------------------------------
# Plain versions: the same functions in fp32 on the inputs' device
# ---------------------------------------------------------------------------


def attn_bwd_preprocess_plain(o, do):
    """Plain version of the preprocess kernel."""
    return (o.float() * do.float()).sum(dim=-1)


def _plain_sweep(q, k, v, do, lse, delta, *, causal, sm_scale, window,
                 softcap, alibi_slopes, dropout_rate, dropout_seed, q_seg, kv_seg,
                 block_sizes=None):
    """Per chunk of q rows (bounding the score matrix's memory): the row
    slice, q and dO in fp32, P∘M and dS, and K expanded to the q heads.  P
    is rebuilt from the passed lse as exp(S − lse), exactly 0 where masked
    (so a row that saw no key, whose lse is DEFAULT_MASK_VALUE, gives 0); M
    is the dropout mask (1 without dropout).  ``block_sizes`` changes
    nothing here."""
    del block_sizes
    b, hq, n_q, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hq != hkv:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)
    kt = kf.transpose(-1, -2)
    bias = _row_bias(alibi_slopes, q.device)
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * hq * n_kv))
    for r0 in range(0, n_q, rows):
        r1 = min(n_q, r0 + rows)
        qc, doc = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        x = torch.matmul(qc, kt) * sm_scale
        if softcap:
            x = softcap * torch.tanh(x / softcap)
        s = bias_and_mask(x, r0, n_q, causal=causal, window=window, bias=bias,
                          q_seg=q_seg, kv_seg=kv_seg)
        p = torch.exp(s - lse[:, :, r0:r1, None])  # masked: exp(-inf) = 0
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        if dropout_rate:
            keep = dropout_rows(q, r0, r1, n_kv, dropout_rate, dropout_seed)
            dp = dp * keep
            pd = p * keep
        else:
            pd = p
        ds = p * (dp - delta[:, :, r0:r1, None])
        if softcap:
            ds = ds * (1.0 - (x / softcap) ** 2)
        yield slice(r0, r1), qc, doc, pd, ds, kf


def attn_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal, sm_scale,
                       window=0, softcap=0.0, alibi_slopes=None,
                       dropout_rate=0.0, dropout_seed=0, q_seg=None, kv_seg=None,
                       block_sizes=None):
    """Plain version of the dK/dV sweep kernel (any ``block_sizes``)."""
    del block_sizes
    b, hq, _, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    dk = torch.zeros((b, hq, n_kv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, qc, doc, pd, ds, _ in _plain_sweep(
            q, k, v, do, lse, delta, **_kw(causal, sm_scale, window, softcap,
                                           alibi_slopes, dropout_rate,
                                           dropout_seed, q_seg, kv_seg)):
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dv += torch.matmul(pd.transpose(-1, -2), doc)
    dk *= sm_scale
    if hq != hkv:
        dk = dk.view(b, hkv, hq // hkv, n_kv, d).sum(dim=2)
        dv = dv.view(b, hkv, hq // hkv, n_kv, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def attn_bwd_dq_plain(q, k, v, do, lse, delta, *, causal, sm_scale, window=0,
                      softcap=0.0, alibi_slopes=None, dropout_rate=0.0,
                      dropout_seed=0, q_seg=None, kv_seg=None, block_sizes=None):
    """Plain version of the dQ sweep kernel (any ``block_sizes``)."""
    del block_sizes
    dq = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    for rows, _, _, _, ds, kf in _plain_sweep(
            q, k, v, do, lse, delta, **_kw(causal, sm_scale, window, softcap,
                                           alibi_slopes, dropout_rate,
                                           dropout_seed, q_seg, kv_seg)):
        dq[:, :, rows] = (torch.matmul(ds, kf) * sm_scale).to(q.dtype)
    return dq


def attn_bwd_plain(q, k, v, o, lse, do, *, causal: bool, sm_scale: float,
                   window: int = 0, softcap: float = 0.0, alibi_slopes=None,
                   dropout_rate: float = 0.0, dropout_seed: int = 0, q_seg=None,
                   kv_seg=None, block_sizes=None):
    """Plain PyTorch version of :func:`attn_bwd`: the three kernels' plain
    versions in turn, in fp32 on the inputs' device (any ``block_sizes``)."""
    del block_sizes
    kw = _kw(causal, sm_scale, window, softcap, alibi_slopes, dropout_rate,
             dropout_seed, q_seg, kv_seg)
    delta = attn_bwd_preprocess_plain(o, do)
    dk, dv = attn_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    return attn_bwd_dq_plain(q, k, v, do, lse, delta, **kw), dk, dv
