"""Attention above head dim 1024 in bf16 / fp16: route ``"wide_scores"``.

The kernels are ``csrc/wide_scores.cuh``, built as ``csrc/attn_fwd_scores.cu``
(the forward's score and product passes), ``csrc/attn_bwd_scores.cu`` (the
backward's score pass and its dQ and dK / dV product passes) and
``csrc/paged_verify_wide.cu`` (paged verify's score and product passes and
the merge of its key splits), each entry with its own launch count.  They
replace, above 1024, the forward and the two backward sweeps of the JAX
package's TPU kernels (``ops/fwd_kernel.py::_fwd_kernel``,
``ops/bwd_kernel.py::_bwd_dkv_kernel`` and ``_bwd_dq_kernel``, and the
routes they carry) and the multi-token verify mode of
``ops/decode.py::_decode_kernel``, with every mode:

- the forward's **score pass** (:func:`fwd_scores`) computes S = Q Kᵀ once
  for each (128 q rows, 128 keys) tile the mask lets through, summed over
  the whole head dim, then scaled, softcapped, biased and masked into base-2
  units, and stores S in fp32 with each row's (max, sum of exp2) of the
  tile; its **product pass** (:func:`fwd_product`) forms P = exp2(S − lse)
  (dropped) and O = P V a 256-column chunk at a time, the lse merged from
  the tiles' (max, sum) in key-tile order;
- the backward's **score pass** (:func:`bwd_scores`) computes S and dP = dO
  Vᵀ once a tile and stores P∘M and dS = P∘(dP∘M − D) (times the softcap's
  derivative) in 16 bits; its **products** give dQ = scale · dS K
  (:func:`dq_product`) and dV = (P∘M)ᵀ dO, dK = scale · dSᵀ Q
  (:func:`dkv_product`), each output element with one owner, every sum in a
  fixed order, no atomics;
- paged verify (:func:`verify_call`, called by ``ops/decode.py
  paged_verify_attention``) runs the forward's two passes over the T · G
  (token, q head) rows of each (sequence, kv head), row t · G + g, on q
  folded and scaled in its dtype (:func:`verify_rows`, the JAX wrapper's
  ``qg``), keys gathered through the page table: the **score pass**
  (:func:`verify_scores`) applies the K scale, the softcap, the ALiBi bias
  and each row's horizon; the **product pass** (:func:`verify_product`)
  forms P = exp2(S − m) times the V scale (rounded against the row's max,
  as the TPU kernel rounds it) and P V / l over each static key split of
  whole key tiles; :func:`verify_combine` merges the splits in split order.

The passes meet in scratch that the caller allocates here, from PyTorch's
allocator on the current stream (so graph captures and
``max_memory_allocated`` see it): dense rows of the call's q tiles, of
which only the visible tiles are written and read.  A call whose scratch
passes :data:`..geometry.WIDE_SCORES_SCRATCH_BYTES` runs in waves of
consecutive (batch × head, q tile) tiles (:func:`..geometry.wide_scores_waves`,
static arithmetic on the shapes); dK and dV then carry an fp32 sum across
waves in wave order, and a call in several waves is bitwise the call in one.

Each pass has its plain version beside it (``*_plain``: the same function in
fp32 on the inputs' device, one q tile at a time, so that waves change no
bit of it either); a wrapper takes it for CPU tensors and launches its
kernel for CUDA tensors.  :func:`attn_fwd_scores` and :func:`attn_bwd_scores`
compose the passes wave by wave; ``ops/fwd_kernel.py attn_fwd`` and
``ops/bwd_kernel.py attn_bwd`` call them on this route.
"""

from __future__ import annotations

import ctypes

import torch

from .. import geometry as geo
from .._cuda import DTYPE_CODES, CudaKernel, ptr, stream_handle
from .fwd_kernel import (
    DEFAULT_MASK_VALUE,
    LN2,
    LOG2E,
    MOD_ARGS,
    ROUTE_CODES,
    V_KINDS,
    dropout_keep_mask,
    int32_seed,
    mod_args,
)

TILE = geo.WIDE_SCORES_TILE  # q rows and keys of a score tile
ROUTE = "wide_scores"

_DIMS = [ctypes.c_int] * 7  # dtype, B, Hq, Hkv, Nq, Nkv, D
# sm_scale, causal, window, softcap
_SCALARS = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float]
_WAVE = [ctypes.c_int] * 3 + [ctypes.c_void_p]  # f0, f1, route, stream
# q, k, s, stats, q_seg, kv_seg
FWD_SCORES_KERNEL = CudaKernel("attn_fwd_scores.cu", "attn_fwd_scores",
                               [ctypes.c_void_p] * 6 + _DIMS + _SCALARS + MOD_ARGS + _WAVE)
# s, stats, v, o, lse; dtype, v_kind, B, Hq, Hkv, Nq, Nkv, D
FWD_PRODUCT_KERNEL = CudaKernel("attn_fwd_scores.cu", "attn_fwd_product",
                                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + _SCALARS
                                + MOD_ARGS + _WAVE)
# q, k, v, dout, lse, delta, p, ds, q_seg, kv_seg
BWD_SCORES_KERNEL = CudaKernel("attn_bwd_scores.cu", "attn_bwd_scores",
                               [ctypes.c_void_p] * 10 + _DIMS + _SCALARS + MOD_ARGS + _WAVE)
# p, ds, q, k, dout, dq, dk, dv, dk_acc, dv_acc; kind, dtype, B, Hq, Hkv, Nq,
# Nkv, D; scale, causal, window
_PRODUCT_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + _WAVE)
# One C entry, two wrappers: the dQ product and the dK / dV product, each
# with its own launch count.
DQ_PRODUCT_KERNEL = CudaKernel("attn_bwd_scores.cu", "attn_bwd_product", _PRODUCT_ARGS)
DKV_PRODUCT_KERNEL = CudaKernel("attn_bwd_scores.cu", "attn_bwd_product", _PRODUCT_ARGS)
_PRODUCT_DQ, _PRODUCT_DKV = 1, 2  # csrc/wide_scores.cuh kProductDq / kProductDkv


def _kernel(name: str) -> CudaKernel:
    """A pass's build, looked up at call time so that a check may swap it."""
    return globals()[name]


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def key_tiles(qt: int, n_q: int, n_kv: int, causal: bool, window: int) -> tuple:
    """The key tiles [lo, hi) that q tile ``qt`` sees (``csrc/common.cuh``
    ``kv_tiles<128, 128>``): the tiles the passes compute, store and read."""
    q_off = n_kv - n_q
    row_lo, row_hi = qt * TILE, min(qt * TILE + TILE, n_q)
    col_lo, col_hi = 0, n_kv
    if causal:
        col_hi = min(n_kv, row_hi + q_off)
        if window:
            col_lo = max(0, row_lo + q_off - window + 1)
    return col_lo // TILE, (-(-col_hi // TILE) if col_hi > 0 else 0)


def _tile(f: int, hq: int, hkv: int, n_q: int, n_kv: int, causal: bool, window: int):
    """Tile f of a call: (batch, q head, kv head, rows [r0, r1), keys [k0,
    k1) it sees, its key tiles [lo, hi))."""
    n_qt = n_tiles(n_q)
    bh, qt = divmod(f, n_qt)
    b, h = divmod(bh, hq)
    lo, hi = key_tiles(qt, n_q, n_kv, causal, window)
    r0, r1 = qt * TILE, min(qt * TILE + TILE, n_q)
    return b, h, h // (hq // hkv), r0, r1, lo * TILE, min(hi * TILE, n_kv), lo, hi


def scratch_mask(q, k, wave, causal: bool, window: int = 0):
    """Where a wave's scratch holds a pair: [(f1 − f0) 128, keys padded to
    128] bool, True on each tile's rows inside Nq and keys inside Nkv of the
    key tiles it sees (what the passes write and read)."""
    _, hq, n_q, _ = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    mask = torch.zeros(((wave[1] - wave[0]) * TILE, n_tiles(n_kv) * TILE), dtype=torch.bool,
                       device=q.device)
    for f in range(*wave):
        _, _, _, r0, r1, k0, k1, _, _ = _tile(f, hq, hkv, n_q, n_kv, causal, window)
        lr = (f - wave[0]) * TILE
        mask[lr:lr + r1 - r0, k0:k1] = True
    return mask


def waves(q, k, backward: bool) -> list:
    """:func:`..geometry.wide_scores_waves` of a call on q and k, at the
    cap :data:`..geometry.WIDE_SCORES_SCRATCH_BYTES` holds when called."""
    b, hq, n_q, _ = q.shape
    return geo.wide_scores_waves(b, hq, n_q, k.shape[2], backward)


def _check(q, what: str) -> None:
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: route {ROUTE} takes bf16 / fp16, not {q.dtype}")
    if not geo.chunked(q.shape[-1]):
        raise ValueError(f"{what}: route {ROUTE} takes head dims above "
                         f"{geo.WIDE_CUT_MAX_HEAD_DIM} that are a multiple of 128, "
                         f"not {q.shape[-1]}")


def _args(q, k, wave, causal, sm_scale, window, softcap, alibi_slopes, dropout_rate,
          dropout_seed):
    b, hq, n_q, d = q.shape
    return ((b, hq, k.shape[1], n_q, k.shape[2], d),
            (float(sm_scale), int(bool(causal)), int(window), float(softcap)),
            mod_args(alibi_slopes, dropout_rate, dropout_seed, q.device),
            (int(wave[0]), int(wave[1]), ROUTE_CODES[ROUTE], stream_handle(q.device)))


def _bias_mask(x, b, h, r0, k0, n_q, n_kv, *, causal, window, alibi_slopes, q_seg, kv_seg):
    """Scores ``x`` of rows [r0, ..) and keys [k0, ..) of (batch b, q head h)
    with the ALiBi bias −m_h·(q_pos − col) added and −inf where masked: the
    kernels' order (``fwd_kernel.bias_and_mask`` at a key offset)."""
    rows = torch.arange(r0, r0 + x.shape[0], device=x.device)[:, None]
    cols = torch.arange(k0, k0 + x.shape[1], device=x.device)[None, :]
    pos = rows + (n_kv - n_q)
    if alibi_slopes is not None:
        x = x - float(alibi_slopes[h]) * (pos - cols).float()
    visible = cols < n_kv
    if causal:
        visible = visible & (cols <= pos)
        if window:
            visible = visible & ((pos - cols) < window)
    if q_seg is not None:
        q_ids = q_seg[b, r0:r0 + x.shape[0], None]
        visible = visible & (q_ids == kv_seg[b, None, k0:k0 + x.shape[1]])
    return x.masked_fill(~visible, float("-inf"))


def _keep(b, h, r0, r1, k0, k1, rate, seed, device):
    """:func:`..fwd_kernel.dropout_keep_mask` of rows [r0, r1) x keys [k0, k1)."""
    return dropout_keep_mask(int32_seed(seed), b, h,
                             torch.arange(r0, r1, device=device)[:, None],
                             torch.arange(k0, k1, device=device)[None, :], rate)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


def fwd_scratch(q, k, wave):
    """The forward's scratch of a wave: S [(f1 − f0) 128, keys padded to
    128] fp32 and each row's (max, sum) of each key tile [(f1 − f0) 128,
    key tiles, 2] fp32, uninitialised (only the visible tiles are
    written)."""
    rows, n_kt = (wave[1] - wave[0]) * TILE, n_tiles(k.shape[2])
    return (torch.empty((rows, n_kt * TILE), dtype=torch.float32, device=q.device),
            torch.empty((rows, n_kt, 2), dtype=torch.float32, device=q.device))


def fwd_scores(q, k, wave, *, causal, sm_scale, window=0, softcap=0.0, alibi_slopes=None,
               q_seg=None, kv_seg=None, **_):
    """The forward's score pass over the wave's tiles: (S, stats) as
    :func:`fwd_scratch` lays them out, S in base-2 units (masked −inf).  The
    kernel on a CUDA device, :func:`fwd_scores_plain` on the CPU."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap,
              alibi_slopes=alibi_slopes, q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return fwd_scores_plain(q, k, wave, **kw)
    _check(q, "fwd_scores")
    s, stats = fwd_scratch(q, k, wave)
    dims, scalars, mods, tail = _args(q, k, wave, causal, sm_scale, window, softcap,
                                      alibi_slopes, 0.0, 0)
    _kernel("FWD_SCORES_KERNEL").launch(
        ptr(q), ptr(k), ptr(s), ptr(stats), ptr(q_seg), ptr(kv_seg), DTYPE_CODES[q.dtype],
        *dims, *scalars, *mods, *tail)
    return s, stats


def fwd_scores_plain(q, k, wave, *, causal, sm_scale, window=0, softcap=0.0,
                     alibi_slopes=None, q_seg=None, kv_seg=None, **_):
    """Plain version of the forward's score pass, in fp32 on the inputs'
    device, one q tile at a time (tiles the mask hides: S −inf, stats (−inf,
    0))."""
    _, hq, n_q, _ = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    s, stats = fwd_scratch(q, k, wave)
    s.fill_(float("-inf"))
    stats[..., 0] = float("-inf")
    stats[..., 1] = 0.0
    for f in range(*wave):
        bi, h, kvh, r0, r1, k0, k1, lo, hi = _tile(f, hq, hkv, n_q, n_kv, causal, window)
        if k0 >= k1:
            continue
        x = torch.matmul(q[bi, h, r0:r1].float(), k[bi, kvh, k0:k1].float().T) * sm_scale
        if softcap:
            x = softcap * torch.tanh(x / softcap)
        x = _bias_mask(x, bi, h, r0, k0, n_q, n_kv, causal=causal, window=window,
                       alibi_slopes=alibi_slopes, q_seg=q_seg, kv_seg=kv_seg) * LOG2E
        lr = (f - wave[0]) * TILE
        s[lr:lr + r1 - r0, k0:k1] = x
        full = torch.full((r1 - r0, (hi - lo) * TILE), float("-inf"), device=q.device)
        full[:, :k1 - k0] = x
        full = full.view(r1 - r0, hi - lo, TILE)
        m = full.amax(dim=-1)
        m_use = torch.where(torch.isneginf(m), 0.0, m)
        stats[lr:lr + r1 - r0, lo:hi, 0] = m
        stats[lr:lr + r1 - r0, lo:hi, 1] = torch.exp2(full - m_use[..., None]).sum(dim=-1)
    return s, stats


def fwd_product(s, stats, v, o, lse, wave, *, causal, window=0, alibi_slopes=None,
                dropout_rate=0.0, dropout_seed=0, sm_scale=1.0, softcap=0.0, **_):
    """The forward's product pass over the wave's tiles: their rows of O (q's
    dtype) and lse (fp32, natural base) written in place, from the score
    pass's ``s`` and ``stats`` and V (q's dtype or fp8).  The kernel on a
    CUDA device, :func:`fwd_product_plain` on the CPU."""
    kw = dict(causal=causal, window=window, dropout_rate=dropout_rate,
              dropout_seed=dropout_seed)
    if o.device.type == "cpu":
        return fwd_product_plain(s, stats, v, o, lse, wave, **kw)
    _check(o, "fwd_product")
    dims, scalars, mods, tail = _args(o, v, wave, causal, sm_scale, window, softcap,
                                      alibi_slopes, dropout_rate, dropout_seed)
    _kernel("FWD_PRODUCT_KERNEL").launch(
        ptr(s), ptr(stats), ptr(v), ptr(o), ptr(lse), DTYPE_CODES[o.dtype],
        V_KINDS.get(v.dtype, 0), *dims, *scalars, *mods, *tail)


def fwd_product_plain(s, stats, v, o, lse, wave, *, causal, window=0, dropout_rate=0.0,
                      dropout_seed=0, **_):
    """Plain version of the forward's product pass, in fp32 on the inputs'
    device (fp8 V upcast exactly), one q tile at a time, reading only the
    key tiles the q tile sees."""
    _, hq, n_q, _ = o.shape
    hkv, n_kv = v.shape[1], v.shape[2]
    for f in range(*wave):
        bi, h, kvh, r0, r1, k0, k1, lo, hi = _tile(f, hq, hkv, n_q, n_kv, causal, window)
        lr = (f - wave[0]) * TILE
        rows = slice(lr, lr + r1 - r0)
        if k0 >= k1:
            o[bi, h, r0:r1] = 0
            lse[bi, h, r0:r1] = DEFAULT_MASK_VALUE
            continue
        st = stats[rows, lo:hi]
        m = st[..., 0].amax(dim=-1)
        m_use = torch.where(torch.isneginf(m), 0.0, m)
        l = (st[..., 1] * torch.exp2(st[..., 0] - m_use[:, None])).sum(dim=-1)
        seen = l > 0
        lse2 = torch.where(seen, m_use + torch.log2(torch.where(seen, l, 1.0)), 0.0)
        p = torch.exp2(s[rows, k0:k1] - lse2[:, None])
        if dropout_rate:
            p = p * _keep(bi, h, r0, r1, k0, k1, dropout_rate, dropout_seed, p.device)
        o[bi, h, r0:r1] = torch.matmul(p, v[bi, kvh, k0:k1].float()).to(o.dtype)
        lse[bi, h, r0:r1] = torch.where(seen, lse2 * LN2, DEFAULT_MASK_VALUE)


def attn_fwd_scores(q, k, v, *, causal, sm_scale, window=0, softcap=0.0, alibi_slopes=None,
                    dropout_rate=0.0, dropout_seed=0, q_seg=None, kv_seg=None):
    """(O [B, Hq, Nq, d] in q's dtype, lse [B, Hq, Nq] fp32) of the forward on
    route ``"wide_scores"``: each wave's score pass, then its product pass
    (their plain versions on CPU tensors).  Arguments as
    ``fwd_kernel.attn_fwd``'s, validated by the caller."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap,
              alibi_slopes=alibi_slopes, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              q_seg=q_seg, kv_seg=kv_seg)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.shape[2] == 0:
        o.zero_()
        lse.fill_(DEFAULT_MASK_VALUE)
        return o, lse
    for wave in waves(q, k, False):
        s, stats = fwd_scores(q, k, wave, **kw)
        fwd_product(s, stats, v, o, lse, wave, **kw)
    return o, lse


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------


def bwd_scratch(q, k, wave):
    """The backward's scratch of a wave: P∘M and dS [(f1 − f0) 128, keys
    padded to 128] in q's dtype, uninitialised (only the visible tiles are
    written)."""
    shape = ((wave[1] - wave[0]) * TILE, n_tiles(k.shape[2]) * TILE)
    return (torch.empty(shape, dtype=q.dtype, device=q.device),
            torch.empty(shape, dtype=q.dtype, device=q.device))


def bwd_scores(q, k, v, do, lse, delta, wave, *, causal, sm_scale, window=0, softcap=0.0,
               alibi_slopes=None, dropout_rate=0.0, dropout_seed=0, q_seg=None, kv_seg=None,
               **_):
    """The backward's score pass over the wave's tiles: (P∘M, dS) as
    :func:`bwd_scratch` lays them out.  The kernel on a CUDA device,
    :func:`bwd_scores_plain` on the CPU."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap,
              alibi_slopes=alibi_slopes, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              q_seg=q_seg, kv_seg=kv_seg)
    if q.device.type == "cpu":
        return bwd_scores_plain(q, k, v, do, lse, delta, wave, **kw)
    _check(q, "bwd_scores")
    p, ds = bwd_scratch(q, k, wave)
    dims, scalars, mods, tail = _args(q, k, wave, causal, sm_scale, window, softcap,
                                      alibi_slopes, dropout_rate, dropout_seed)
    _kernel("BWD_SCORES_KERNEL").launch(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(p), ptr(ds), ptr(q_seg),
        ptr(kv_seg), DTYPE_CODES[q.dtype], *dims, *scalars, *mods, *tail)
    return p, ds


def bwd_scores_plain(q, k, v, do, lse, delta, wave, *, causal, sm_scale, window=0,
                     softcap=0.0, alibi_slopes=None, dropout_rate=0.0, dropout_seed=0,
                     q_seg=None, kv_seg=None, **_):
    """Plain version of the backward's score pass (``bwd_kernel``'s
    ``_plain_sweep`` arithmetic), in fp32 on the inputs' device, one q tile
    at a time, rounded to q's dtype as stored (tiles the mask hides: 0)."""
    _, hq, n_q, _ = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    p_out, ds_out = bwd_scratch(q, k, wave)
    p_out.zero_()
    ds_out.zero_()
    for f in range(*wave):
        bi, h, kvh, r0, r1, k0, k1, _, _ = _tile(f, hq, hkv, n_q, n_kv, causal, window)
        if k0 >= k1:
            continue
        xc = torch.matmul(q[bi, h, r0:r1].float(), k[bi, kvh, k0:k1].float().T) * sm_scale
        if softcap:
            xc = softcap * torch.tanh(xc / softcap)
        x = _bias_mask(xc, bi, h, r0, k0, n_q, n_kv, causal=causal, window=window,
                       alibi_slopes=alibi_slopes, q_seg=q_seg, kv_seg=kv_seg)
        p = torch.exp(x - lse[bi, h, r0:r1, None])  # masked: exp(-inf) = 0
        dp = torch.matmul(do[bi, h, r0:r1].float(), v[bi, kvh, k0:k1].float().T)
        keep = (_keep(bi, h, r0, r1, k0, k1, dropout_rate, dropout_seed, p.device)
                if dropout_rate else 1.0)
        ds = p * (dp * keep - delta[bi, h, r0:r1, None])
        if softcap:
            ds = ds * (1.0 - (xc / softcap) ** 2)
        lr = (f - wave[0]) * TILE
        p_out[lr:lr + r1 - r0, k0:k1] = (p * keep).to(q.dtype)
        ds_out[lr:lr + r1 - r0, k0:k1] = ds.to(q.dtype)
    return p_out, ds_out


def _product_args(q, k, wave, causal, sm_scale, window):
    b, hq, n_q, d = q.shape
    return ((DTYPE_CODES[q.dtype], b, hq, k.shape[1], n_q, k.shape[2], d),
            (float(sm_scale), int(bool(causal)), int(window)),
            (int(wave[0]), int(wave[1]), ROUTE_CODES[ROUTE], stream_handle(q.device)))


def dq_product(ds, q, k, dq, wave, *, causal, sm_scale, window=0, **_):
    """The dQ product over the wave's tiles: their rows of dQ = sm_scale dS K
    written in place (q's dtype).  The kernel on a CUDA device,
    :func:`dq_product_plain` on the CPU."""
    if q.device.type == "cpu":
        return dq_product_plain(ds, q, k, dq, wave, causal=causal, sm_scale=sm_scale,
                                window=window)
    _check(q, "dq_product")
    dims, scalars, tail = _product_args(q, k, wave, causal, sm_scale, window)
    _kernel("DQ_PRODUCT_KERNEL").launch(
        None, ptr(ds), ptr(q), ptr(k), None, ptr(dq), None, None, None, None, _PRODUCT_DQ,
        *dims, *scalars, *tail)


def dq_product_plain(ds, q, k, dq, wave, *, causal, sm_scale, window=0, **_):
    """Plain version of the dQ product, fp32, one q tile at a time over the
    keys it sees."""
    _, hq, n_q, _ = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    for f in range(*wave):
        bi, h, kvh, r0, r1, k0, k1, _, _ = _tile(f, hq, hkv, n_q, n_kv, causal, window)
        lr = (f - wave[0]) * TILE
        if k0 >= k1:
            dq[bi, h, r0:r1] = 0
            continue
        dq[bi, h, r0:r1] = (torch.matmul(ds[lr:lr + r1 - r0, k0:k1].float(),
                                         k[bi, kvh, k0:k1].float()) * sm_scale).to(dq.dtype)


def dkv_carry(q, k, wave_list):
    """dK's and dV's fp32 sums across waves ([B, Hkv, Nkv, d] each), where a
    wave boundary falls inside a kv head's tiles; else (None, None)."""
    per_kv = q.shape[1] // k.shape[1] * n_tiles(q.shape[2])
    if all(f0 % per_kv == 0 and f1 % per_kv == 0 for f0, f1 in wave_list):
        return None, None
    shape = k.shape
    return (torch.empty(shape, dtype=torch.float32, device=q.device),
            torch.empty(shape, dtype=torch.float32, device=q.device))


def dkv_product(p, ds, q, k, do, dk, dv, carry, wave, *, causal, sm_scale, window=0, **_):
    """The dK / dV product over the wave's tiles: for each kv head they touch,
    dV += (P∘M)ᵀ dO and dK += dSᵀ Q over the GQA group's q heads in order,
    each q tile in order; a kv head whose tiles end in the wave has dK
    (times sm_scale) and dV written in k's dtype, one whose tiles run on
    has its fp32 sums in ``carry`` (:func:`dkv_carry`), from which the next
    wave starts.  The kernel on a CUDA device, :func:`dkv_product_plain` on
    the CPU."""
    if q.device.type == "cpu":
        return dkv_product_plain(p, ds, q, k, do, dk, dv, carry, wave, causal=causal,
                                 sm_scale=sm_scale, window=window)
    _check(q, "dkv_product")
    dims, scalars, tail = _product_args(q, k, wave, causal, sm_scale, window)
    _kernel("DKV_PRODUCT_KERNEL").launch(
        ptr(p), ptr(ds), ptr(q), None, ptr(do), None, ptr(dk), ptr(dv), ptr(carry[0]),
        ptr(carry[1]), _PRODUCT_DKV, *dims, *scalars, *tail)


def dkv_product_plain(p, ds, q, k, do, dk, dv, carry, wave, *, causal, sm_scale, window=0,
                      **_):
    """Plain version of the dK / dV product: fp32 sums in the kernel's order of
    q heads and q tiles (one q tile's keys at a time), carried across waves
    in ``carry`` as the kernel carries them."""
    _, hq, n_q, _ = q.shape
    hkv, n_kv = k.shape[1], k.shape[2]
    per_kv = hq // hkv * n_tiles(n_q)
    f0, f1 = wave
    for bk in range(f0 // per_kv, (f1 - 1) // per_kv + 1):
        bi, kvh = divmod(bk, hkv)
        first, last = f0 <= bk * per_kv, f1 >= (bk + 1) * per_kv
        if first:
            acc_k = torch.zeros(k.shape[2:], dtype=torch.float32, device=q.device)
            acc_v = torch.zeros_like(acc_k)
        else:
            acc_k, acc_v = carry[0][bi, kvh].clone(), carry[1][bi, kvh].clone()
        for f in range(max(f0, bk * per_kv), min(f1, (bk + 1) * per_kv)):
            _, h, _, r0, r1, k0, k1, _, _ = _tile(f, hq, hkv, n_q, n_kv, causal, window)
            if k0 >= k1:
                continue
            lr = (f - f0) * TILE
            rows = slice(lr, lr + r1 - r0)
            acc_v[k0:k1] += torch.matmul(p[rows, k0:k1].float().T, do[bi, h, r0:r1].float())
            acc_k[k0:k1] += torch.matmul(ds[rows, k0:k1].float().T, q[bi, h, r0:r1].float())
        if last:
            dk[bi, kvh] = (acc_k * sm_scale).to(dk.dtype)
            dv[bi, kvh] = acc_v.to(dv.dtype)
        else:
            carry[0][bi, kvh] = acc_k
            carry[1][bi, kvh] = acc_v


def attn_bwd_scores(q, k, v, do, lse, delta, *, causal, sm_scale, window=0, softcap=0.0,
                    alibi_slopes=None, dropout_rate=0.0, dropout_seed=0, q_seg=None,
                    kv_seg=None, sweeps=("dkv", "dq")):
    """The backward sweeps on route ``"wide_scores"`` given the preprocess's
    ``delta``: each wave's score pass, then its dK / dV and dQ products
    (their plain versions on CPU tensors).  Returns {"dq": dQ, "dk": dK,
    "dv": dV} for the ``sweeps`` asked."""
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap,
              alibi_slopes=alibi_slopes, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
              q_seg=q_seg, kv_seg=kv_seg)
    out = {}
    if "dq" in sweeps:
        out["dq"] = torch.empty_like(q)
    if "dkv" in sweeps:
        out["dk"], out["dv"] = torch.empty_like(k), torch.empty_like(v)
    wave_list = waves(q, k, True)
    carry = dkv_carry(q, k, wave_list) if "dkv" in sweeps else (None, None)
    for wave in wave_list:
        p, ds = bwd_scores(q, k, v, do, lse, delta, wave, **kw)
        if "dkv" in sweeps:
            dkv_product(p, ds, q, k, do, out["dk"], out["dv"], carry, wave, **kw)
        if "dq" in sweeps:
            dq_product(ds, q, k, out["dq"], wave, **kw)
    return out


# ---------------------------------------------------------------------------
# Paged multi-token verify
# ---------------------------------------------------------------------------

_VERIFY_DIMS = [ctypes.c_int] * 8  # B, Hq, Hkv, T, P, page_size, pages_per_seq, D
# qs, q dtype, K pool, pool kind, K scales, lengths, table, s, stats; softcap,
# ALiBi slopes
VERIFY_SCORES_KERNEL = CudaKernel(
    "paged_verify_wide.cu", "paged_verify_scores",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    + _VERIFY_DIMS + [ctypes.c_float, ctypes.c_void_p] + _WAVE)
# s, stats, V pool; q dtype, pool kind; V scales, lengths, table, o, part_o,
# part_lse; splits
VERIFY_PRODUCT_KERNEL = CudaKernel(
    "paged_verify_wide.cu", "paged_verify_product",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + _VERIFY_DIMS
    + [ctypes.c_int] + _WAVE)
# part_o, part_lse, o; q dtype, rows, splits, D; stream
VERIFY_COMBINE_KERNEL = CudaKernel(
    "paged_verify_wide.cu", "paged_verify_combine",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def verify_rows(q, num_kv_heads: int, scale: float):
    """q [B, Hq, T, d] folded into the rows of each (sequence, kv head),
    row t · G + g, and multiplied by ``scale`` (sm_scale already rounded to
    q's dtype) in q's dtype: [B · Hkv, T · G, d], one rounding a value (the
    JAX wrapper's ``qg``)."""
    b, hq, t, d = q.shape
    g = hq // num_kv_heads
    out = torch.empty((b, num_kv_heads, t, g, d), dtype=q.dtype, device=q.device)
    torch.mul(q.reshape(b, num_kv_heads, g, t, d).transpose(2, 3), scale, out=out)
    return out.view(b * num_kv_heads, t * g, d)


def verify_waves(batch: int, num_kv_heads: int, rows: int, n_keys: int) -> list:
    """The waves of a verify call of ``rows`` = T · G rows a (sequence, kv
    head) over a table of ``n_keys`` keys: :func:`..geometry.wide_scores_waves`
    over its tiles f = (b · Hkv + kv head) · ceil(rows / 128) + row tile,
    at the cap :data:`..geometry.WIDE_SCORES_SCRATCH_BYTES` holds when
    called."""
    return geo.wide_scores_waves(batch, num_kv_heads, rows, n_keys, False)


def verify_key_hi(lengths, tokens: int, rows: int, g: int, max_len: int):
    """Per tile of one (sequence, kv head): the keys [0, key_hi) that some
    row of row tile i sees, ``lengths`` a host list of the sequences'
    lengths: [[key_hi of each row tile] for each sequence]."""
    out = []
    for n in lengths:
        out.append([max(0, min(n - tokens + 1 + (min(r0 + TILE, rows) - 1) // g, max_len))
                    for r0 in range(0, rows, TILE)])
    return out


def _pool_rows(payload, int4: bool, kvh: int, table_row, n_keys: int, page_size: int, dtype):
    """Keys [0, n_keys) of one sequence's table from one kv head of a pool
    (values, or payloads unscaled) in ``dtype`` as fp32: [n_keys, d]."""
    pages = table_row[: -(-n_keys // page_size)].long()
    g = payload[kvh, pages]  # [pages, stored rows, d]
    if int4:
        from .quantization import unpack_int4_rows

        g = unpack_int4_rows(g)
    return g.reshape(-1, g.shape[-1])[:n_keys].to(dtype).float()


def _scale_rows(scales, kvh: int, table_row, n_keys: int, page_size: int):
    """The fp32 scales of keys [0, n_keys) of one sequence: [n_keys]."""
    pages = table_row[: -(-n_keys // page_size)].long()
    return scales[kvh, pages].reshape(-1)[:n_keys]


def verify_scratch(wave, n_keys: int, device):
    """A verify wave's scratch, as :func:`fwd_scratch` lays it out: S
    [(f1 − f0) 128, key tiles · 128] fp32 and each row's (max, sum) of each
    key tile [(f1 − f0) 128, key tiles, 2], uninitialised (only the key
    tiles some row of a tile sees are written)."""
    rows, n_kt = (wave[1] - wave[0]) * TILE, n_tiles(n_keys)
    return (torch.empty((rows, n_kt * TILE), dtype=torch.float32, device=device),
            torch.empty((rows, n_kt, 2), dtype=torch.float32, device=device))


def verify_scratch_mask(wave, key_hi, num_kv_heads: int, rows: int, n_keys: int, device):
    """Where a verify wave's scratch holds a pair the passes write and read:
    [(f1 − f0) 128, key tiles · 128] bool, True on each tile's rows inside
    T · G and keys below its ``key_hi`` (:func:`verify_key_hi`)."""
    n_rt = n_tiles(rows)
    mask = torch.zeros(((wave[1] - wave[0]) * TILE, n_tiles(n_keys) * TILE), dtype=torch.bool,
                       device=device)
    for f in range(*wave):
        bk, rt = divmod(f, n_rt)
        lr = (f - wave[0]) * TILE
        mask[lr:lr + min(TILE, rows - rt * TILE), :key_hi[bk // num_kv_heads][rt]] = True
    return mask


def _verify_check(qs, what: str) -> None:
    if qs.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: route {ROUTE} takes bf16 / fp16 q, not {qs.dtype}")
    if not geo.chunked(qs.shape[-1]):
        raise ValueError(f"{what}: route {ROUTE} takes pool head dims above "
                         f"{geo.WIDE_CUT_MAX_HEAD_DIM} that are a multiple of 128, "
                         f"not {qs.shape[-1]}")


def _verify_dims(pools, num_q_heads, tokens, table, d):
    hkv, num_pages = pools.k.shape[:2]
    return (table.shape[0], num_q_heads, hkv, tokens, num_pages, pools.page_size,
            table.shape[1], d)


def _verify_tail(wave, device):
    return int(wave[0]), int(wave[1]), ROUTE_CODES[ROUTE], stream_handle(device)


def verify_scores(qs, pools, lengths, table, wave, *, num_q_heads, tokens, softcap=0.0,
                  alibi_slopes=None):
    """Verify's score pass over the wave's tiles from the folded rows ``qs``
    (:func:`verify_rows`) and the K pool of ``pools`` (``ops/decode.py``
    ``_Pools``): (S, stats) as :func:`verify_scratch` lays them out, S in
    base-2 units (masked −inf).  The kernel on a CUDA device,
    :func:`verify_scores_plain` on the CPU."""
    kw = dict(num_q_heads=num_q_heads, tokens=tokens, softcap=softcap,
              alibi_slopes=alibi_slopes)
    if qs.device.type == "cpu":
        return verify_scores_plain(qs, pools, lengths, table, wave, **kw)
    _verify_check(qs, "verify_scores")
    n_keys = table.shape[1] * pools.page_size
    s, stats = verify_scratch(wave, n_keys, qs.device)
    slopes = mod_args(alibi_slopes, 0.0, 0, qs.device)[0]
    _kernel("VERIFY_SCORES_KERNEL").launch(
        ptr(qs), DTYPE_CODES[qs.dtype], ptr(pools.k), pools.kind, ptr(pools.k_sc), ptr(lengths),
        ptr(table), ptr(s), ptr(stats), *_verify_dims(pools, num_q_heads, tokens, table,
                                                      qs.shape[-1]),
        float(softcap), slopes, *_verify_tail(wave, qs.device))
    return s, stats


def _verify_tiles(wave, pools, lengths, table, num_q_heads, tokens):
    """Each tile f of the wave: (f, sequence, kv head, rows [r0, r1), the
    sequence's length and its length clamped to the table, key_hi)."""
    hkv = pools.k.shape[0]
    g, max_len = num_q_heads // hkv, table.shape[1] * pools.page_size
    rows = tokens * g
    lens = [int(n) for n in lengths.tolist()]
    hi = verify_key_hi(lens, tokens, rows, g, max_len)
    n_rt = n_tiles(rows)
    for f in range(*wave):
        bk, rt = divmod(f, n_rt)
        bi, kvh = divmod(bk, hkv)
        r0 = rt * TILE
        yield f, bi, kvh, r0, min(r0 + TILE, rows), lens[bi], min(max(lens[bi], 0), max_len), \
            hi[bi][rt]


def verify_scores_plain(qs, pools, lengths, table, wave, *, num_q_heads, tokens, softcap=0.0,
                        alibi_slopes=None):
    """Plain version of verify's score pass, in fp32 on the inputs' device,
    one tile at a time (``paged_verify_plain``'s arithmetic: payloads cast to
    q's dtype unscaled, the K scale on S, the softcap, the ALiBi bias −m ·
    (q_pos − col) with q_pos = length − T + t, each row's horizon; key tiles
    no row of a tile sees: S −inf, stats (−inf, 0))."""
    hkv = pools.k.shape[0]
    g, ps = num_q_heads // hkv, pools.page_size
    max_len = table.shape[1] * ps
    s, stats = verify_scratch(wave, max_len, qs.device)
    s.fill_(float("-inf"))
    stats[..., 0] = float("-inf")
    stats[..., 1] = 0.0
    for f, bi, kvh, r0, r1, n, alen, key_hi in _verify_tiles(wave, pools, lengths, table,
                                                             num_q_heads, tokens):
        if key_hi == 0:
            continue
        k = _pool_rows(pools.k, pools.int4, kvh, table[bi], key_hi, ps, qs.dtype)
        x = torch.matmul(qs[bi * hkv + kvh, r0:r1].float(), k.T)
        if pools.quantized:
            x = x * _scale_rows(pools.k_sc, kvh, table[bi], key_hi, ps)
        if softcap:
            x = softcap * torch.tanh(x * (1.0 / softcap))
        r = torch.arange(r0, r1, device=qs.device)
        t = r // g
        cols = torch.arange(key_hi, device=qs.device)
        if alibi_slopes is not None:
            m = torch.tensor(alibi_slopes, dtype=torch.float32, device=qs.device)[kvh * g + r % g]
            x = x - m[:, None] * ((alen - tokens + t)[:, None] - cols).float()
        x = x * LOG2E
        x = x.masked_fill(cols >= (n - tokens + 1 + t).clamp(max=max_len)[:, None],
                          float("-inf"))
        hi = n_tiles(key_hi)
        full = torch.full((r1 - r0, hi * TILE), float("-inf"), device=qs.device)
        full[:, :key_hi] = x
        lr = (f - wave[0]) * TILE
        s[lr:lr + r1 - r0, :hi * TILE] = full
        full = full.view(r1 - r0, hi, TILE)
        mx = full.amax(dim=-1)
        m_use = torch.where(torch.isneginf(mx), 0.0, mx)
        stats[lr:lr + r1 - r0, :hi, 0] = mx
        stats[lr:lr + r1 - r0, :hi, 1] = torch.exp2(full - m_use[..., None]).sum(dim=-1)
    return s, stats


def verify_split_tiles(n_keys: int, splits: int):
    """Key tiles a split of a verify call on this route: ceil(key tiles /
    splits), the last split shorter."""
    return -(-n_tiles(n_keys) // splits)


def verify_product(s, stats, pools, lengths, table, wave, out, *, num_q_heads, tokens,
                   splits=1, dtype=None):
    """Verify's product pass over the wave's tiles and every key split:
    with one split ``out`` is O [B, Hq, T, d] in q's dtype, written in
    place; with several it is (part_o [splits, B · Hq · T, d], part_lse
    [splits, B · Hq · T]) fp32, each split's partial normalized over its own
    keys and its lse (−inf where it shows a row no key), for
    :func:`verify_combine`.  ``dtype`` is q's (that of O).  The kernel on a
    CUDA device, :func:`verify_product_plain` on the CPU."""
    kw = dict(num_q_heads=num_q_heads, tokens=tokens, splits=splits, dtype=dtype)
    if s.device.type == "cpu":
        return verify_product_plain(s, stats, pools, lengths, table, wave, out, **kw)
    o, parts = (out, (None, None)) if splits == 1 else (None, out)
    d = pools.v.shape[-1]
    _kernel("VERIFY_PRODUCT_KERNEL").launch(
        ptr(s), ptr(stats), ptr(pools.v), DTYPE_CODES[dtype], pools.kind, ptr(pools.v_sc),
        ptr(lengths), ptr(table), ptr(o), ptr(parts[0]), ptr(parts[1]),
        *_verify_dims(pools, num_q_heads, tokens, table, d), int(splits),
        *_verify_tail(wave, s.device))


def verify_product_plain(s, stats, pools, lengths, table, wave, out, *, num_q_heads, tokens,
                         splits=1, dtype=None):
    """Plain version of verify's product pass, in fp32 on the inputs' device,
    one tile and split at a time: the row's max m and sum l over the split's
    key tiles merged from their (max, sum) in key-tile order, P = exp2(S −
    m) times the V scale rounded to q's dtype (against the row's max, as
    ``paged_verify_plain`` rounds it), O = P V / l over the split's keys a
    row sees."""
    hkv = pools.k.shape[0]
    g, ps = num_q_heads // hkv, pools.page_size
    max_len = table.shape[1] * ps
    per = verify_split_tiles(max_len, splits)
    n_kt = n_tiles(max_len)
    for f, bi, kvh, r0, r1, _, _, key_hi in _verify_tiles(wave, pools, lengths, table,
                                                          num_q_heads, tokens):
        lr = (f - wave[0]) * TILE
        rows = slice(lr, lr + r1 - r0)
        r = torch.arange(r0, r1, device=s.device)
        orow = (bi * num_q_heads + kvh * g + r % g) * tokens + r // g
        v = _pool_rows(pools.v, pools.int4, kvh, table[bi], key_hi, ps, dtype)
        vsc = (_scale_rows(pools.v_sc, kvh, table[bi], key_hi, ps) if pools.quantized
               else None)
        for sp in range(splits):
            lo, hi = sp * per, min(sp * per + per, n_kt, n_tiles(key_hi))
            k0, k1 = lo * TILE, min(hi * TILE, key_hi)
            if lo < hi:
                st = stats[rows, lo:hi]
                m = st[..., 0].amax(dim=-1)
                m_use = torch.where(torch.isneginf(m), 0.0, m)
                l = (st[..., 1] * torch.exp2(st[..., 0] - m_use[:, None])).sum(dim=-1)
                seen = l > 0
                lse2 = torch.where(seen, m_use + torch.log2(torch.where(seen, l, 1.0)), 0.0)
                p = torch.exp2(s[rows, k0:k1] - m_use[:, None])
                if vsc is not None:
                    p = p * vsc[k0:k1]
                o = torch.matmul(p.to(dtype).float(), v[k0:k1])
                o = o * torch.where(seen, 1.0 / torch.where(seen, l, 1.0), 0.0)[:, None]
            else:
                seen = torch.zeros(r1 - r0, dtype=torch.bool, device=s.device)
                lse2 = torch.zeros(r1 - r0, device=s.device)
                o = torch.zeros((r1 - r0, v.shape[-1]), device=s.device)
            if splits == 1:
                out.view(-1, out.shape[-1])[orow] = o.to(out.dtype)
            else:
                out[0][sp, orow] = o
                out[1][sp, orow] = torch.where(seen, lse2 * LN2, float("-inf"))


def verify_combine(part_o, part_lse, o):
    """The key splits of a verify call merged in split order into O [B, Hq,
    T, d] (q's dtype), written in place: ``csrc/wide.cuh``'s
    ``wide_combine_kernel`` on a CUDA device, ``ops/decode.py``
    ``combine_partials`` on the CPU."""
    if o.device.type == "cpu":
        from .decode import combine_partials

        merged, _ = combine_partials(part_o, part_lse)
        o.view(-1, o.shape[-1])[:] = merged.to(o.dtype)
        return
    _kernel("VERIFY_COMBINE_KERNEL").launch(
        ptr(part_o), ptr(part_lse), ptr(o), DTYPE_CODES[o.dtype], part_o.shape[1],
        part_o.shape[0], part_o.shape[2], stream_handle(o.device))


def verify_call(q, pools, lengths, table, *, scale, splits=1, softcap=0.0, alibi_slopes=None,
                parts=None):
    """O [B, Hq, T, d] (q's dtype) of paged verify on route ``"wide_scores"``
    (q at the pools' head dim, ``scale`` sm_scale rounded to q's dtype):
    q folded and scaled (:func:`verify_rows`), each wave's score pass, then
    its product pass over ``splits`` key splits of whole key tiles, and the
    splits merged (:func:`verify_combine`); their plain versions on CPU
    tensors.  ``parts`` is the (part_o, part_lse) scratch of a split call
    (fresh tensors if None)."""
    b, hq, tokens, d = q.shape
    hkv = pools.k.shape[0]
    n_keys = table.shape[1] * pools.page_size
    o = torch.empty_like(q)
    if splits > 1 and parts is None:
        rows = b * hq * tokens
        parts = (torch.empty((splits, rows, d), dtype=torch.float32, device=q.device),
                 torch.empty((splits, rows), dtype=torch.float32, device=q.device))
    qs = verify_rows(q, hkv, scale)
    kw = dict(num_q_heads=hq, tokens=tokens)
    for wave in verify_waves(b, hkv, tokens * (hq // hkv), n_keys):
        s, stats = verify_scores(qs, pools, lengths, table, wave, softcap=softcap,
                                 alibi_slopes=alibi_slopes, **kw)
        verify_product(s, stats, pools, lengths, table, wave, o if splits == 1 else parts,
                       splits=splits, dtype=q.dtype, **kw)
    if splits > 1:
        verify_combine(*parts, o)
    return o
