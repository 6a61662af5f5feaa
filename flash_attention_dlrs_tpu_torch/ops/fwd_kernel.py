"""Attention forward kernel: wrapper, plain version and launch counts.

The kernels are ``csrc/attn_fwd.cuh`` (fp32, and the C entry) and
``csrc/attn_fwd_sm90.cuh`` (bf16 / fp16), built six times, once for each
head dim without and with segment ids (:func:`fwd_kernel`), each build with
its own launch count: ``csrc/attn_fwd.cu`` (head dim 128,
:data:`FWD_KERNEL`), ``csrc/attn_fwd_seg.cu`` (:data:`FWD_SEG_KERNEL`),
``csrc/attn_fwd_d64.cu`` / ``attn_fwd_d64_seg.cu`` and
``csrc/attn_fwd_d256.cu`` / ``attn_fwd_d256_seg.cu``; a seventh,
``csrc/attn_fwd_tiles.cu`` (:data:`FWD_TILES_KERNEL`), carries the 64-key
tiles at d 64 and 128 that a caller may pin or the tuner pick
(``block_sizes``, :mod:`..tuning`), mode-free; an eighth,
``csrc/attn_fwd_wide.cu`` (:data:`FWD_WIDE_KERNEL`, the kernels of
``csrc/wide.cuh``), every head dim above 256 that is a multiple of 128,
with every mode, but the bf16 / fp16 ones above 1024, which take the score
and product passes of ``csrc/wide_scores.cuh`` (:mod:`.wide_scores`, built
as ``csrc/attn_fwd_scores.cu``).  Each call takes one of six routes,
fixed by :func:`fwd_route` from the call's types and width alone and
counted in :data:`ROUTE_LAUNCHES`: ``"wgmma"`` (the Hopper kernel of
``csrc/attn_fwd_sm90.cuh``: warpgroup products, TMA, warp specialisation;
every bf16/fp16 call at d 64, 128 and 256), ``"fp32"`` (CUDA cores, true
fp32), and at the wide head dims ``"wide_wgmma"`` (bf16/fp16: the same
Hopper machinery with the head dim split among warpgroups and, above 512,
the CTAs of a cluster, scores computed once a key tile; to 1024),
``"wide_scores"`` (bf16/fp16 above 1024: a score pass computes S once a
tile over the whole head dim, a product pass O = P V a column chunk at a
time, both on wgmma; no width cap) and ``"wide_fp32"``; ``"wide_chunk"``
(column-chunked on ``mma.sync``) is only paged verify's above 1024
(``ops/decode.py``).
The C entry refuses a route that
cannot carry a call; nothing switches routes at run time.  It replaces
the forward of the TPU kernels ``ops/fwd_kernel.py::_fwd_kernel``,
``ops/fwd_mid.py::_mid_kernel``, ``ops/fwd_mid.py::_mid_strip_kernel`` and
``ops/fwd_small.py::_small_kernel`` of the JAX package with their whole
feature set (causal or not, GQA, ragged lengths, window, softcap, ALiBi,
attention dropout, segment ids, fp8 V).  :func:`attn_fwd` sends CPU tensors
to the plain PyTorch version :func:`attn_fwd_plain` and CUDA tensors to the
kernel.

Attention dropout draws its mask from :func:`dropout_keep_mask`, a pure
function of (seed, batch, q head, q row, kv column) that the kernels compute
bit for bit alike (``csrc/common.cuh``), so the backward and a remat
recompute regenerate the forward's mask.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._cuda import DTYPE_CODES, CudaKernel, ptr, register_launch_counts, stream_handle
from ..geometry import chunked, default_block_kv, is_wide

# Finite sentinel for masked scores and the lse of a row that sees no key.
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# The head dims the kernels are built for, each with every mode; any other
# head_dim up to 256 is zero-padded to the next of them (:func:`kernel_width`),
# as the JAX package pads to 128 lanes.  Wider heads are padded to a multiple
# of 128, as in the JAX package, and run on the wide builds
# (``csrc/wide.cuh``), at every width (:func:`check_kernel_head_dim`).
KERNEL_WIDTHS = (64, 128, 256)
FWD_HEAD_DIMS = KERNEL_WIDTHS


# V's kind code of the forward's C interface (csrc/common.cuh kVE4M3 /
# kVE5M2; 0: V has q's dtype): fp8 V is dequantized to q's dtype as the
# kernel stages it, forward only.
V_KINDS = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}
FP8_DTYPES = tuple(V_KINDS)

# ALiBi slopes and attention dropout of the C interfaces (csrc/common.cuh Mods)
MOD_ARGS = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int]
_M32 = 0xFFFFFFFF

_FWD_ARGS = (
    [ctypes.c_void_p] * 7  # q, k, v, o, lse, q_seg, kv_seg
    + [ctypes.c_int] * 8  # dtype, v_kind, B, Hq, Hkv, Nq, Nkv, D
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + MOD_ARGS
    + [ctypes.c_int]  # route
    + [ctypes.c_void_p]  # stream
)
FWD_KERNEL = CudaKernel("attn_fwd.cu", "attn_fwd", _FWD_ARGS)
FWD_SEG_KERNEL = CudaKernel("attn_fwd_seg.cu", "attn_fwd_seg", _FWD_ARGS)
FWD_D64_KERNEL = CudaKernel("attn_fwd_d64.cu", "attn_fwd_d64", _FWD_ARGS)
FWD_D64_SEG_KERNEL = CudaKernel("attn_fwd_d64_seg.cu", "attn_fwd_d64_seg", _FWD_ARGS)
FWD_D256_KERNEL = CudaKernel("attn_fwd_d256.cu", "attn_fwd_d256", _FWD_ARGS)
FWD_D256_SEG_KERNEL = CudaKernel("attn_fwd_d256_seg.cu", "attn_fwd_d256_seg", _FWD_ARGS)
# The other key tiles (csrc/attn_fwd_tiles.cu): the arguments of the builds
# above with the tile's keys before the route.
FWD_TILES_KERNEL = CudaKernel("attn_fwd_tiles.cu", "attn_fwd_tiles",
                              _FWD_ARGS[:-2] + [ctypes.c_int] + _FWD_ARGS[-2:])
# Every head dim above 256 (csrc/attn_fwd_wide.cu): the builds' arguments.
FWD_WIDE_KERNEL = CudaKernel("attn_fwd_wide.cu", "attn_fwd_wide", _FWD_ARGS)

# The C entries' route codes (csrc/attn_fwd.cuh kRouteF32 / kRouteWgmma,
# csrc/wide.cuh kRouteWideF32 / kRouteWideWgmma / kRouteWideChunk,
# csrc/wide_scores.cuh kRouteWideScores; 3 was a retired route's) and the
# launches of each route, over every build; set to 0 by whoever reads them.
# The backward sweeps share the codes (ops/bwd_kernel.py): "wide_wgmma"
# names the 16-bit wide forward and both wide sweeps to 1024,
# "wide_scores" those above; "wide_chunk" is paged verify's above 1024
# (ops/decode.py), whose codes these are too.
ROUTE_CODES = {"fp32": 0, "wgmma": 1, "wide_fp32": 2, "wide_wgmma": 4, "wide_chunk": 5,
               "wide_scores": 6}
ROUTE_LAUNCHES = register_launch_counts(dict.fromkeys(ROUTE_CODES, 0))
# The wgmma and wide_wgmma routes' launches by head dim and key tile
# ("d128_kv64", "d512_kv32"), over every build; set to 0 by whoever reads
# them.
TILE_LAUNCHES = register_launch_counts({})


def kernel_width(head_dim: int) -> int:
    """The head dim that ``head_dim`` is zero-padded to: the least of
    :data:`KERNEL_WIDTHS` that holds it, and above 256 the next multiple of
    128 (the JAX package's lanes), the wide builds' widths.
    Zero columns add nothing to a score and zero V columns are sliced off,
    so the padding is exact."""
    for width in KERNEL_WIDTHS:
        if head_dim <= width:
            return width
    return -(-head_dim // 128) * 128


def check_kernel_head_dim(head_dim: int, what: str, widths=KERNEL_WIDTHS) -> None:
    """Raise unless ``what`` (a kernel) is built for ``head_dim``: one of
    ``widths``, or a wide head dim (any multiple of 128 above 256:
    :func:`..geometry.is_wide`); every other head dim is padded to one by
    the entry points (:func:`kernel_width`)."""
    if head_dim in widths or is_wide(head_dim):
        return
    raise ValueError(f"{what}: head_dim must be one of {widths} or a multiple of 128 "
                     f"above 256, got {head_dim}")


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its last axis zero-padded to ``width`` (itself when it is
    that wide already); fp8 tensors are padded as their bytes (zero bits
    are 0.0)."""
    pad = width - x.shape[-1]
    if pad == 0:
        return x
    if x.dtype in V_KINDS:
        return torch.nn.functional.pad(x.view(torch.uint8), (0, pad)).view(x.dtype)
    return torch.nn.functional.pad(x, (0, pad))


def fwd_route(dtype, head_dim: int, segments: bool = False, fp8_v: bool = False,
              alibi: bool = False, dropout: bool = False) -> str:
    """The kernel route of a forward call, from its types alone:

    =========  =========================================================
    route      calls
    =========  =========================================================
    fp32       q in float32 (CUDA cores, true fp32; any V kind, segments)
    wgmma      bf16 / fp16 q, with or without segment ids, V of q's dtype
               or fp8
    wide_fp32  as fp32, at a wide head dim (``csrc/wide.cuh``)
    wide_wgmma as wgmma, at a wide head dim up to 1024 (``csrc/wide.cuh``)
    wide_scores as wgmma, at a wide head dim above 1024
               (``csrc/wide_scores.cuh``: a score pass, then a product
               pass, :mod:`.wide_scores`)
    =========  =========================================================

    Segment ids, fp8 V, ALiBi and dropout are modes of every route at every
    head dim and change none (the mode arguments are kept so that a caller
    can name what it runs).  d must be 64, 128, 256 or a multiple of 128
    above 256 (:func:`check_kernel_head_dim`); anything else raises."""
    del segments, fp8_v, alibi, dropout
    check_kernel_head_dim(head_dim, "attn_fwd kernel", FWD_HEAD_DIMS)
    wide = "wide_" if is_wide(head_dim) else ""
    if dtype == torch.float32:
        return wide + "fp32"
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"attn_fwd kernel takes fp32/bf16/fp16, not {dtype}")
    return "wide_scores" if chunked(head_dim) else wide + "wgmma"


def fwd_kernel(head_dim: int, segments: bool, block_kv=None) -> CudaKernel:
    """The build of the forward that takes a call, by head dim and by
    whether it has segment ids: the module attribute ``FWD[_D<d>][_SEG]_KERNEL``
    (no suffix at d 128), ``FWD_WIDE_KERNEL`` at a wide head dim (above 1024
    the fp32 route's; bf16 / fp16 there take :mod:`.wide_scores`' passes), or
    ``FWD_TILES_KERNEL`` for a ``block_kv`` other than the head dim's own,
    looked up at call time so that a check may swap a build."""
    if is_wide(head_dim):
        return globals()["FWD_WIDE_KERNEL"]
    if block_kv not in (None, default_block_kv(head_dim)):
        return globals()["FWD_TILES_KERNEL"]
    dim = "" if head_dim == 128 else f"_D{head_dim}"
    return globals()[f"FWD{dim}{'_SEG' if segments else ''}_KERNEL"]


# Rows of scores the plain version materializes at once (bounds its memory).
_PLAIN_CHUNK_ELEMS = 1 << 26


def _mul32(x, c: int):
    """(x · c) mod 2^32 for uint32 values held in int64, in 16-bit halves so
    no product leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def lowbias32(x):
    """Wellons' lowbias32 mixer on uint32 values held in an int64 tensor:
    the bits of the JAX package's int32 version (wrapping multiplies,
    logical shifts)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep_mask(seed, b, h, rows, cols, rate: float):
    """Keep/scale factor M ∈ {0, 1/(1−rate)} (fp32) of attention dropout at
    (seed, batch b, q head h, local q row, kv column), broadcast over its
    integer arguments: the JAX package's ``fwd_kernel.dropout_keep_mask``
    bit for bit.  seed_bh = lowbias32(seed ^ (b·65599 + h)); bits =
    lowbias32(row ^ lowbias32(col + seed_bh)); kept where
    (bits & 0xFFFFFF)·2^-24 >= rate (rate as fp32)."""
    dev = next((x.device for x in (rows, cols, b, h, seed) if torch.is_tensor(x)),
               None)

    def u32(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev) & _M32

    seed_bh = lowbias32(u32(seed) ^ ((u32(b) * 65599 + u32(h)) & _M32))
    bits = lowbias32(u32(rows) ^ lowbias32((u32(cols) + seed_bh) & _M32))
    u = (bits & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    keep = u >= torch.tensor(rate, dtype=torch.float32, device=dev)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=dev)
    return torch.where(keep, scale, torch.zeros((), dtype=torch.float32, device=dev))


def int32_seed(seed) -> int:
    """A dropout seed as the int32 the kernels take, wrapping past 2^31 as
    the JAX package's int32 seeds do."""
    return (int(seed) + (1 << 31)) % (1 << 32) - (1 << 31)


@functools.lru_cache(maxsize=None)
def _slopes_on(slopes: tuple, device: torch.device):
    """ALiBi slopes as an fp32 tensor on ``device``, made once per slope set
    and device (a model has one set), so a kernel call copies nothing from
    the host.  Callers never write to it."""
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def mod_args(alibi_slopes, dropout_rate: float, dropout_seed: int, device):
    """The C interfaces' (slopes, rate, keep scale, seed): ALiBi slopes as a
    cached fp32 tensor on ``device`` (null without ALiBi), the keep scale
    1/(1−rate) rounded once from double."""
    slopes = None if alibi_slopes is None else _slopes_on(tuple(alibi_slopes), device)
    rate = float(dropout_rate)
    return (ptr(slopes), rate, 1.0 / (1.0 - rate), int32_seed(dropout_seed or 0))


def _row_bias(slopes, device):
    """[1, H, 1, 1] fp32 slopes for the plain versions, or None."""
    if slopes is None:
        return None
    return torch.tensor(slopes, dtype=torch.float32, device=device)[None, :, None, None]


def check_segments(q, k, q_seg, kv_seg) -> None:
    """Raise unless the kernels can take (q_seg, kv_seg): both None, or
    contiguous int32 [B, Nq] / [B, Nkv] on q's device (what
    ops/flash_attention.py _normalize_segments makes)."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg go together")
    if q_seg is None:
        return
    for name, t, n in (("q_seg", q_seg, q.shape[2]), ("kv_seg", kv_seg, k.shape[2])):
        if tuple(t.shape) != (q.shape[0], n):
            raise ValueError(f"{name} {tuple(t.shape)} must be [B, N] = {(q.shape[0], n)}")
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous int32 on {q.device}")



def attn_fwd(q, k, v, *, causal: bool, sm_scale: float, window: int = 0,
             softcap: float = 0.0, alibi_slopes=None, dropout_rate: float = 0.0,
             dropout_seed: int = 0, q_seg=None, kv_seg=None, block_sizes=None):
    """(O [B, Hq, Nq, d] in q's dtype, L [B, Hq, Nq] fp32 natural-base lse).

    ``alibi_slopes`` (one float per q head, or None) adds the true ALiBi
    bias −m_h·(q_pos − col) after the softcap, q_pos = row + Nkv − Nq, so L
    is the true logsumexp.  ``dropout_rate`` > 0 drops P (after its row sum,
    so L is undropped) with :func:`dropout_keep_mask` of ``dropout_seed``.
    ``q_seg`` [B, Nq] / ``kv_seg`` [B, Nkv] (int32, or None) are segment
    ids: row i sees key j only where q_seg[b, i] == kv_seg[b, j].  V may be
    fp8 (e4m3fn / e5m2) beside fp32/bf16/fp16 q and k.  Arguments are
    validated by the caller (ops/flash_attention.py).  ``block_sizes`` (a
    :class:`..tuning.BlockSizes`, or None: the head dim's own tile) sets the
    wgmma route's key tile, ``block_kv``; a tile no build carries for the
    call raises ``ValueError`` before any launch, and the fp32 route (its
    own fixed tiles) and the plain version take any tile alike.  CPU
    tensors take :func:`attn_fwd_plain`; CUDA tensors launch the kernel on
    the route of :func:`fwd_route` (in the build of :func:`fwd_kernel`),
    which takes contiguous inputs with d in {64, 128, 256} or a multiple of
    128 above 256, or raise."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap,
              alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed, q_seg=q_seg, kv_seg=kv_seg,
              block_sizes=block_sizes)
    if q.device.type == "cpu":
        return attn_fwd_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"attn_fwd runs on cpu or cuda, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype and not (name == "v" and t.dtype in V_KINDS):
            raise ValueError(f"{name} has dtype {t.dtype}, q {q.dtype}")
        if t.data_ptr() % 16:  # 16-byte loads and TMA tensor maps
            raise ValueError(f"{name} must start on a 16-byte boundary")
    check_segments(q, k, q_seg, kv_seg)
    b, hq, n_q, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    route = fwd_route(q.dtype, d, q_seg is not None, v.dtype in V_KINDS,
                      alibi_slopes is not None, bool(dropout_rate))
    block_kv = default_block_kv(d)
    if route in ("wgmma", "wide_wgmma", "wide_scores") and block_sizes is not None:
        block_sizes.check(d, alibi=alibi_slopes is not None, dropout=bool(dropout_rate),
                          segments=q_seg is not None, fp8_v=v.dtype in V_KINDS)
        block_kv = block_sizes.block_kv
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, n_q), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        lse.fill_(DEFAULT_MASK_VALUE)
        return o, lse
    if route == "wide_scores":
        from . import wide_scores

        del kw["block_sizes"]
        o, lse = wide_scores.attn_fwd_scores(q, k, v, **kw)
        ROUTE_LAUNCHES[route] += 1
        return o, lse
    tile = [] if block_kv == default_block_kv(d) else [block_kv]
    fwd_kernel(d, q_seg is not None, block_kv).launch(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(q_seg), ptr(kv_seg),
        DTYPE_CODES[q.dtype], V_KINDS.get(v.dtype, 0), b, hq, hkv, n_q, n_kv, d,
        float(sm_scale), int(bool(causal)), int(window), float(softcap),
        *mod_args(alibi_slopes, dropout_rate, dropout_seed, q.device),
        *tile, ROUTE_CODES[route], stream_handle(q.device),
    )
    ROUTE_LAUNCHES[route] += 1
    if route in ("wgmma", "wide_wgmma"):
        key = f"d{d}_kv{block_kv}"
        TILE_LAUNCHES[key] = TILE_LAUNCHES.get(key, 0) + 1
    return o, lse


def bias_and_mask(x, r0: int, n_q: int, *, causal, window, bias, q_seg=None,
                  kv_seg=None):
    """Scores ``x`` (scaled and softcapped, q rows [r0, r0 + rows) against
    every key) with the ALiBi bias −m_h·(q_pos − col) added (``bias`` from
    :func:`_row_bias`, or None) and −inf where masked (causal / window, then
    unequal segment ids when ``q_seg`` / ``kv_seg`` are given): the kernels'
    order."""
    n_kv = x.shape[-1]
    r1 = r0 + x.shape[-2]
    pos = torch.arange(r0, r1, device=x.device)[:, None] + (n_kv - n_q)
    col = torch.arange(n_kv, device=x.device)[None, :]
    if bias is not None:
        x = x - bias * (pos - col).float()
    if causal:
        visible = col <= pos
        if window:
            visible = visible & ((pos - col) < window)
        x = x.masked_fill(~visible, float("-inf"))
    if q_seg is not None:
        same = q_seg[:, None, r0:r1, None] == kv_seg[:, None, None, :]
        x = x.masked_fill(~same, float("-inf"))
    return x


def dropout_rows(q, r0, r1, n_kv, dropout_rate, dropout_seed):
    """:func:`dropout_keep_mask` of q rows [r0, r1) of every (batch, head)
    against all Nkv columns, [B, Hq, r1 − r0, Nkv]."""
    b, hq = q.shape[:2]
    dev = q.device
    return dropout_keep_mask(
        int32_seed(dropout_seed), torch.arange(b, device=dev)[:, None, None, None],
        torch.arange(hq, device=dev)[None, :, None, None],
        torch.arange(r0, r1, device=dev)[None, None, :, None],
        torch.arange(n_kv, device=dev)[None, None, None, :], dropout_rate)


def attn_fwd_plain(q, k, v, *, causal: bool, sm_scale: float, window: int = 0,
                   softcap: float = 0.0, alibi_slopes=None,
                   dropout_rate: float = 0.0, dropout_seed: int = 0, q_seg=None,
                   kv_seg=None, block_sizes=None):
    """Plain PyTorch version of the kernel: the same function in fp32 on the
    inputs' device (fp8 V upcast exactly), in chunks of q rows so the score
    matrix stays bounded; ``block_sizes`` changes nothing here.  Empty rows
    give O = 0 and L = DEFAULT_MASK_VALUE."""
    del block_sizes
    b, hq, n_q, d = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if hq != hkv:
        kf = kf.repeat_interleave(hq // hkv, dim=1)
        vf = vf.repeat_interleave(hq // hkv, dim=1)
    kt = kf.transpose(-1, -2)
    bias = _row_bias(alibi_slopes, q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, n_q), dtype=torch.float32, device=q.device)
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * hq * n_kv))
    for r0 in range(0, n_q, rows):
        r1 = min(n_q, r0 + rows)
        s = torch.matmul(q[:, :, r0:r1].float(), kt) * sm_scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = bias_and_mask(s, r0, n_q, causal=causal, window=window, bias=bias,
                          q_seg=q_seg, kv_seg=kv_seg)
        m = s.amax(dim=-1, keepdim=True)
        empty = torch.isneginf(m)
        p = torch.exp(s - torch.where(empty, 0.0, m))
        l = p.sum(dim=-1, keepdim=True)
        if dropout_rate:
            p = p * dropout_rows(q, r0, r1, n_kv, dropout_rate, dropout_seed)
        o[:, :, r0:r1] = (
            torch.matmul(p, vf) / torch.where(empty, 1.0, l)
        ).to(q.dtype)
        lse[:, :, r0:r1] = torch.where(
            empty, DEFAULT_MASK_VALUE, m + torch.log(l))[..., 0]
    return o, lse
