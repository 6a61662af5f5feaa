"""Hopper geometry model and tile pruning, the port of ``flash_attention_dlrs_tpu/geometry.py``.

The reference's autotuner pruned its Triton configurations against a
hand-written GA102 SRAM model (``SRAM = 99 * 1024`` bytes and a safety
factor, reference ``src/autotune_configs.py:10,18,169-245``); the JAX
package models a TPU core's VMEM instead.  Here the budget is the running
card's own (``torch.cuda.get_device_properties``: on the H100 232,448 bytes
of shared memory a CTA may opt into, 132 SMs), and the footprint is the
kernels' own layout, byte for byte: :func:`attention_fwd_smem_bytes` is
``csrc/attn_fwd_sm90.cuh`` ``Layout::BYTES`` and
:func:`attention_bwd_smem_bytes` is ``csrc/attn_bwd_sm90.cuh``
``BwdLayout::BYTES`` (each build reports its own through a
``*_shared_bytes`` entry, which ``chip_smoke.py`` holds these against).
There is no safety margin: the layouts are exact, and a layout past the
budget does not launch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ._cuda import resolve_device

# q rows of a forward CTA (two consumer warpgroups of 64) and resident rows
# of a backward sweep's CTA (csrc/attn_fwd_sm90.cuh BM, attn_bwd_sm90.cuh BR)
CTA_ROWS = 128

# The wide builds (csrc/wide.cuh): every head dim above 256 that is a
# multiple of 128.  A CTA owns WIDE_ROWS rows.  Up to WIDE_CUT_MAX_HEAD_DIM
# the 16-bit forward and verify (route "wide_wgmma") stream key tiles of
# WIDE_FWD_KEYS and cut the head dim among owners and CTAs (:func:`wide_cut`),
# and the 16-bit sweeps (also "wide_wgmma") stream tiles of WIDE_BWD_ROWS
# rows (keys in dQ, q rows in dK/dV) and cut it their own way
# (:func:`wide_bwd_cut`).  The column-chunked kernels (fp32 "wide_fp32" at
# every wide head dim; bf16 / fp16 "wide_chunk" above the cuts,
# :func:`chunked`) own one 128-column chunk of their output a CTA and stream
# tiles of WIDE_KEYS rows: no width cap.  Above the cuts the 16-bit forward
# and sweeps take route "wide_scores" instead (csrc/wide_scores.cuh): a
# score pass of WIDE_SCORES_TILE x WIDE_SCORES_TILE tiles and a product
# pass streaming WIDE_SCORES_ROWS rows a stage into WIDE_SCORES_COLS output
# columns a CTA, through scratch of at most WIDE_SCORES_SCRATCH_BYTES a wave
# (:func:`wide_scores_waves`); only paged verify stays column-chunked there.
WIDE_CUT_MAX_HEAD_DIM = 1024
WIDE_ROWS = 64
WIDE_KEYS = 64
WIDE_FWD_KEYS = 32
WIDE_BWD_ROWS = 32
WIDE_SCORES_TILE = 128
WIDE_SCORES_ROWS = 64
WIDE_SCORES_COLS = 256
WIDE_SCORES_SCRATCH_BYTES = 1 << 29

# The H100 SXM5 (80 GB HBM3) as torch.cuda.get_device_properties reports it;
# current_geometry gives it for the CPU, where no card can be asked.
H100_SXM = dict(
    device_name="NVIDIA H100 80GB HBM3",
    sm_count=132,
    smem_per_block_optin=232448,
    regs_per_sm=65536,
    l2_bytes=50 * 1024 * 1024,
    capability=(9, 0),
)


@dataclasses.dataclass(frozen=True)
class HopperGeometry:
    """What the tuner needs to know of one card."""

    device_name: str
    sm_count: int
    smem_per_block_optin: int  # shared memory one CTA may opt into, bytes
    regs_per_sm: int
    l2_bytes: int
    capability: tuple  # (major, minor)


@functools.lru_cache(maxsize=None)
def _geometry_of(index: int) -> HopperGeometry:
    props = torch.cuda.get_device_properties(index)
    return HopperGeometry(
        device_name=props.name,
        sm_count=props.multi_processor_count,
        smem_per_block_optin=props.shared_memory_per_block_optin,
        regs_per_sm=props.regs_per_multiprocessor,
        l2_bytes=props.L2_cache_size,
        capability=(props.major, props.minor),
    )


def current_geometry(device=None) -> HopperGeometry:
    """The geometry of ``device`` (default ``"cuda"``: the current card,
    and none raises); the written H100 table only when asked for the CPU."""
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cpu":
        return HopperGeometry(**H100_SXM)
    return _geometry_of(torch.cuda.current_device() if device.index is None else device.index)


def supports_fast_fp8(geom: Optional[HopperGeometry] = None) -> bool:
    """Whether the card converts fp8 natively: compute capability 8.9 (Ada)
    and later; True on the CPU (the plain versions, nothing to guard), as
    the JAX package answers True off the TPU."""
    geom = geom or current_geometry()
    return tuple(geom.capability) >= (8, 9)


def attention_fwd_smem_bytes(block_kv: int, head_dim: int, stages: int,
                             segments: bool = False, fp8_v: bool = False) -> int:
    """Shared memory of one forward CTA (``csrc/attn_fwd_sm90.cuh``
    ``layout_bytes``): Q (128 rows), ``stages`` K and V tiles of
    ``block_kv`` keys in 16-bit, with fp8 V the fp8 tiles as loaded, with
    segment ids each K tile's int32 ids, the barriers (1 + 5 per stage, 8
    bytes each) and 1024 bytes of alignment."""
    return (CTA_ROWS * head_dim * 2 + 2 * stages * block_kv * head_dim * 2
            + (stages * block_kv * head_dim if fp8_v else 0)
            + (stages * block_kv * 4 if segments else 0)
            + 8 * (1 + 5 * stages) + 1024)


def fwd_stages(block_kv: int, head_dim: int, segments: bool = False, fp8_v: bool = False,
               geom: Optional[HopperGeometry] = None) -> int:
    """Stages of the forward's ring on tiles of ``block_kv`` keys
    (``csrc/attn_fwd_sm90.cuh`` ``fwd_stages``): the head dim's own tile
    keeps 4 at d 64 and 2 above; another takes as many as fit, at most 4
    and at least 2, so that loads overlap the products (0 if two do not
    fit)."""
    if block_kv == default_block_kv(head_dim):
        return 4 if head_dim == 64 else 2
    budget = (geom or current_geometry("cpu")).smem_per_block_optin
    for stages in (4, 3, 2):
        if attention_fwd_smem_bytes(block_kv, head_dim, stages, segments, fp8_v) <= budget:
            return stages
    return 0


# The d 256 dK/dV sweep's one layout (``csrc/attn_bwd_sm90.cuh``
# ``DkvD256Layout``): a CTA owns 64 keys and streams 64 q rows a stage, 2
# stages deep, whatever ``block_kv_bwd`` (which sets the dQ sweep's keys).
D256_DKV_KEYS = 64
D256_DKV_ROWS = 64


def bwd_stream_rows(head_dim: int, block_kv_bwd: int, dkv: bool) -> int:
    """Rows a sweep streams a stage (q rows in dK/dV, keys in dQ) for a
    call's ``block_kv_bwd``: the d 256 dK/dV sweep always streams
    :data:`D256_DKV_ROWS`; every other sweep ``block_kv_bwd``."""
    return D256_DKV_ROWS if head_dim == 256 and dkv else block_kv_bwd


def bwd_stages(head_dim: int, dkv: bool = True) -> int:
    """Stages of a backward sweep's ring (``csrc/attn_bwd_sm90.cuh``
    ``BwdLayout::STAGES``, ``DkvD256Layout::STAGES``): at d 256 2 in dK/dV
    and 3 in dQ, 4 below, whatever the tile."""
    if head_dim == 256:
        return 2 if dkv else 3
    return 4


def attention_bwd_smem_bytes(block_kv_bwd: int, head_dim: int, segments: bool = False,
                             dkv: bool = True) -> int:
    """Shared memory of one backward sweep's CTA (``csrc/attn_bwd_sm90.cuh``
    ``BwdLayout::BYTES``): the two resident tiles (128 rows), the stages of
    the two streamed tiles of ``block_kv_bwd`` rows, each stage's row
    arrays (dK/dV: lse and D; with segment ids the streamed rows' ids), the
    barriers (1 + 2 per stage) and 1024 bytes of alignment.  The d 256
    dK/dV sweep (``DkvD256Layout::BYTES``) holds 64 resident keys, stages
    of :data:`D256_DKV_ROWS` q rows whatever ``block_kv_bwd``, the P o M and
    dS tiles (64 x 64 in 16 bits each) and two more barriers."""
    stages = bwd_stages(head_dim, dkv)
    row_arrays = (2 if dkv else 0) + (1 if segments else 0)
    if head_dim == 256 and dkv:
        rows = D256_DKV_ROWS
        return (2 * D256_DKV_KEYS * head_dim * 2 + 2 * stages * rows * head_dim * 2
                + 2 * rows * D256_DKV_KEYS * 2 + stages * row_arrays * rows * 4
                + 8 * (1 + 2 * stages + 2) + 1024)
    return (2 * CTA_ROWS * head_dim * 2 + 2 * stages * block_kv_bwd * head_dim * 2
            + stages * row_arrays * block_kv_bwd * 4 + 8 * (1 + 2 * stages) + 1024)


def fits_smem(nbytes: int, geom: Optional[HopperGeometry] = None) -> bool:
    """Whether a CTA of ``nbytes`` of shared memory can launch."""
    return nbytes <= (geom or current_geometry("cpu")).smem_per_block_optin


def is_wide(head_dim: int) -> bool:
    """Whether ``head_dim`` is a width of the wide builds (``csrc/wide.cuh``
    ``wide_head_dim``): any multiple of 128 above 256."""
    return head_dim > 256 and head_dim % 128 == 0


def chunked(head_dim: int) -> bool:
    """Whether ``head_dim`` is a wide width the cluster cuts of the 16-bit
    kernels do not reach (above :data:`WIDE_CUT_MAX_HEAD_DIM`): the bf16 /
    fp16 forward and sweeps run their score and product passes there
    (route ``"wide_scores"``), verify (``"wide_chunk"``) and the fp32
    kernels run column-chunked, decode on ``csrc/paged_decode_chunk.cu``."""
    return is_wide(head_dim) and head_dim > WIDE_CUT_MAX_HEAD_DIM


# The passes of route "wide_scores" (csrc/wide_scores.cuh ScoreLayout,
# ProductLayout): {kind: (stages, bytes of a stage)}.  A score pass's stage
# holds 128 rows x 64 columns of Q and K (and dO, V in the backward), a
# product's the scratch tile and 64 rows x 256 columns of its operand.
_WIDE_SCORES_STAGES = {
    "fwd_scores": (4, 2 * 128 * 128),
    "bwd_scores": (3, 4 * 128 * 128),
    "fwd_product": (3, 128 * 64 * 4 + 64 * 256 * 2),
    "dq_product": (4, 128 * 64 * 2 + 64 * 256 * 2),
    "dkv_product": (4, 128 * 64 * 2 + 64 * 256 * 2),
}
WIDE_SCORES_KINDS = tuple(_WIDE_SCORES_STAGES)


def wide_scores_smem_bytes(kind: str) -> int:
    """Shared memory of one CTA of a pass of route ``"wide_scores"``
    (``csrc/wide_scores.cuh`` ``ScoreLayout<BWD>::BYTES`` /
    ``ProductLayout<KIND>::BYTES``), one layout a pass at every head dim
    and mode: the stages of :data:`_WIDE_SCORES_STAGES`, a score pass's
    128 kv segment ids, a full and an empty barrier a stage and 1024 bytes
    of alignment."""
    stages, stage = _WIDE_SCORES_STAGES[kind]
    ids = WIDE_SCORES_TILE * 4 if kind.endswith("_scores") else 0
    return stages * stage + ids + 8 * 2 * stages + 1024


def wide_scores_tile_bytes(n_kv: int, backward: bool) -> int:
    """Scratch bytes of one q tile of a ``"wide_scores"`` call: its 128 rows
    against every key padded to a whole tile, S in fp32 and each row's (max,
    sum) of each key tile in the forward; P o M and dS in 16 bits in the
    backward."""
    n_kt = -(-n_kv // WIDE_SCORES_TILE)
    pairs = WIDE_SCORES_TILE * n_kt * WIDE_SCORES_TILE
    return 4 * pairs if backward else 4 * pairs + 8 * WIDE_SCORES_TILE * n_kt


def wide_scores_waves(batch: int, q_heads: int, n_q: int, n_kv: int, backward: bool,
                      scratch_bytes: Optional[int] = None) -> list:
    """The waves of a ``"wide_scores"`` call: ranges [f0, f1) of its tiles f
    = (b q_heads + h) ceil(n_q / 128) + q tile, consecutive, each as many
    tiles as :func:`wide_scores_tile_bytes` fits in ``scratch_bytes``
    (:data:`WIDE_SCORES_SCRATCH_BYTES` by default), at least one.  Static
    arithmetic on the shapes: the same call always runs the same waves."""
    cap = WIDE_SCORES_SCRATCH_BYTES if scratch_bytes is None else int(scratch_bytes)
    tiles = batch * q_heads * -(-n_q // WIDE_SCORES_TILE)
    per = max(1, cap // wide_scores_tile_bytes(n_kv, backward))
    return [(f, min(f + per, tiles)) for f in range(0, tiles, per)]


def _refuse_cut(head_dim: int) -> None:
    if chunked(head_dim):
        raise ValueError(
            f"head_dim {head_dim} is above the cluster cuts' {WIDE_CUT_MAX_HEAD_DIM}: its 16-bit "
            "forward and sweeps run score and product passes (route \"wide_scores\", "
            "geometry.wide_scores_smem_bytes), verify and fp32 column-chunked")
    if not is_wide(head_dim):
        raise ValueError(f"head_dim {head_dim} is not a width of the wide builds")


def wide_chunk_smem_bytes(dtype=torch.float32, paged: bool = False,
                          segments: bool = False) -> int:
    """Shared memory of one CTA of the column-chunked kernels (``csrc/wide.cuh``
    ``WideLayout<T>::BYTES``): the fp32 forward and sweeps, and verify
    (``paged``) in every dtype, with or without segment ids, at every head
    dim alike: two stages of each
    streamed operand (64 rows of 128 bytes, each padded by 16), the update
    tile (64 rows of 128 columns of ``dtype``, padded by 16 bytes), in fp32
    each warp's 16 x 68 probabilities (16-bit keeps them in registers), six
    vectors of 64 and 64 row offsets and flags."""
    del paged, segments  # one layout for every mode
    itemsize = torch.empty((), dtype=dtype).element_size()
    chunk = WIDE_ROWS * (128 + 16)
    tile = WIDE_KEYS * (128 * itemsize + 16)
    probs = 4 * 16 * (WIDE_KEYS + 4) * 4 if itemsize == 4 else 0
    return 4 * chunk + tile + probs + 6 * 64 * 4 + 64 * 8 + 64 * 4


def wide_chunk_decode_smem_bytes() -> int:
    """Shared memory of one CTA of the column-chunked decode
    (``csrc/wide.cuh`` ``WdcLayout::BYTES``), every pool kind and head dim:
    q of two heads over 1024 columns in fp32, the 64-key tile's scores and P
    of two heads, its keys' stored-row offsets (8 bytes), int4 halves and K /
    V scales, and three floats a head (running max, row sum, rescale)."""
    keys = 64
    return 2 * 1024 * 4 + 2 * 2 * keys * 4 + keys * (8 + 4 + 4 + 4) + 3 * 2 * 4


def wide_cut(head_dim: int) -> tuple:
    """How the wide_wgmma kernel cuts a wide head dim up to
    :data:`WIDE_CUT_MAX_HEAD_DIM` (``csrc/wide.cuh`` ``wide_cut``): (CTAs a
    cluster, owners a CTA, 64-column chunks an owner).  An owner (a consumer
    warpgroup) holds at most 256 columns of O; a CTA at most 512 columns;
    d 640 and 896 take clusters of 5 and 7 CTAs of one 128-column owner.
    Wider heads raise, naming the column-chunked route."""
    cuts = {384: (1, 2, 3), 512: (1, 2, 4), 640: (5, 1, 2), 768: (2, 2, 3),
            896: (7, 1, 2), 1024: (2, 2, 4)}
    if head_dim not in cuts:
        _refuse_cut(head_dim)
    return cuts[head_dim]


def wide_fwd_stages(head_dim: int) -> int:
    """Stages of the wide_wgmma kernel's K/V ring (``csrc/wide.cuh``
    ``WgLayout::STAGES``): as many as fit beside Q, the partials and
    verify's scales, at most 4: 2 where a CTA holds 512 columns, 3 at 384,
    4 at 128."""
    stages = 4
    while stages > 2 and _wide_fwd_bytes(head_dim, stages, False, True) > H100_SXM[
            "smem_per_block_optin"]:
        stages -= 1
    return stages


def _wide_fwd_bytes(head_dim: int, stages: int, segments: bool, paged: bool) -> int:
    _, nw, c = wide_cut(head_dim)
    cols = 64 * nw * c  # the CTA's columns
    extra = stages * 2 * WIDE_FWD_KEYS * 4 if paged else (
        stages * WIDE_FWD_KEYS * 4 if segments else 0)
    return (WIDE_ROWS * cols * 2 + 2 * stages * WIDE_FWD_KEYS * cols * 2
            + nw * WIDE_ROWS * WIDE_FWD_KEYS * 4 + extra + 8 * (nw + 4 * stages + 2) + 1024)


def wide_fwd_smem_bytes(head_dim: int, segments: bool = False, paged: bool = False) -> int:
    """Shared memory of one CTA of the wide_wgmma kernel (``csrc/wide.cuh``
    ``WgLayout::bytes``), forward or (``paged``) verify: 64 rows of Q over
    the CTA's columns, :func:`wide_fwd_stages` stages of K and V tiles of
    WIDE_FWD_KEYS keys, each owner's 64 x 32 fp32 partial scores, with
    segment ids each K tile's ids, in verify each stage's K and V scales,
    the barriers (one Q barrier an owner, four a stage, two for the
    partials) and 1024 bytes of alignment.  fp8 V takes no bytes (the
    producer converts it from device memory into the 16-bit V stage), so
    the model has no fp8-V flag."""
    return _wide_fwd_bytes(head_dim, wide_fwd_stages(head_dim), segments, paged)


def wide_bwd_cut(head_dim: int, dkv: bool = True) -> tuple:
    """How a 16-bit wide sweep (``dkv``: dK/dV, else dQ) cuts a wide head
    dim (``csrc/wide.cuh`` ``wide_bwd_cut``): (CTAs a cluster, owners a CTA,
    64-column chunks an owner); each CTA holds the partial scores of every
    owner of its cluster.  A dK/dV owner holds dK and dV for 128 columns (2
    x 64 fp32 registers a thread): two a CTA at d 512, one elsewhere.  A dQ
    owner takes 256 columns where the head dim is a multiple of 256, else
    128, one a CTA.  Above :data:`WIDE_CUT_MAX_HEAD_DIM` raises, naming the
    column-chunked route."""
    if not is_wide(head_dim) or chunked(head_dim):
        _refuse_cut(head_dim)
    if dkv:
        return (2, 2, 2) if head_dim == 512 else (head_dim // 128, 1, 2)
    return (head_dim // 256, 1, 4) if head_dim % 256 == 0 else (head_dim // 128, 1, 2)


def _wide_bwd_bytes(head_dim: int, stages: int, segments: bool, dkv: bool) -> int:
    nc, nw, c = wide_bwd_cut(head_dim, dkv)
    cols = 64 * nw * c  # the CTA's columns
    row_arrays = (2 if dkv else 0) + (1 if segments else 0)
    return (2 * WIDE_ROWS * cols * 2 + 2 * stages * WIDE_BWD_ROWS * cols * 2
            + 2 * nc * nw * WIDE_ROWS * WIDE_BWD_ROWS * 4 + stages * row_arrays * WIDE_BWD_ROWS * 4
            + 8 * (1 + 2 * stages + 2) + 1024)


def wide_bwd_stages(head_dim: int, dkv: bool = True) -> int:
    """Stages of a 16-bit wide sweep's ring (``csrc/wide.cuh``
    ``WbLayout::STAGES``): as many as fit with segment ids, at most 4 and
    at least 2."""
    stages = 4
    while stages > 2 and _wide_bwd_bytes(head_dim, stages, True, dkv) > H100_SXM[
            "smem_per_block_optin"]:
        stages -= 1
    return stages


def wide_bwd_smem_bytes(head_dim: int, segments: bool = False, dkv: bool = True) -> int:
    """Shared memory of one CTA of a 16-bit wide sweep (``csrc/wide.cuh``
    ``WbLayout::bytes``), dK/dV (``dkv``) or dQ: the two resident tiles
    (64 rows over the CTA's columns: K and V, or Q and dO),
    :func:`wide_bwd_stages` stages of the two streamed tiles of
    WIDE_BWD_ROWS rows, the 64 x 32 fp32 partial S and dP of every owner of
    the cluster, each stage's row arrays (dK/dV: lse and D; with segment
    ids the streamed rows' ids), the barriers (one resident, two a stage,
    two for the partials) and 1024 bytes of alignment."""
    return _wide_bwd_bytes(head_dim, wide_bwd_stages(head_dim, dkv), segments, dkv)


# The wide decode kernel (csrc/wide.cuh wide_decode_kernel): 8 warps, two q
# heads of a kv head a CTA, the first WIDE_DECODE_PIDS page ids of its key
# split staged in shared memory.  Pool kinds by their code (csrc/paged.cuh
# PoolKind, ops/decode.py POOL_KINDS), with the bytes of a stored element.
WIDE_DECODE_THREADS = 256
WIDE_DECODE_PIDS = 512
POOL_KIND_NAMES = ("fp32", "bf16", "fp16", "int8", "int4", "e4m3", "e5m2")
_POOL_KIND_BYTES = (4, 2, 2, 1, 1, 1, 1)
# An H100 SM's shared memory (228 KB), of which each resident CTA also
# takes 1 KB for the system beside its own (static and dynamic) bytes.
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_CTA = 1024


def _pool_kind(kind) -> int:
    code = POOL_KIND_NAMES.index(kind) if isinstance(kind, str) else kind
    if code not in range(len(POOL_KIND_NAMES)):
        raise ValueError(f"pool kind {kind!r} is not one of {POOL_KIND_NAMES}")
    return code


def wide_decode_ctas_per_sm(head_dim: int) -> int:
    """CTAs of the wide decode kernel an SM holds by design
    (``csrc/wide.cuh`` ``WdLayout::CTAS``, its ``__launch_bounds__``): two
    up to 512 columns (registers and shared memory sized for it), else
    one; above :data:`WIDE_CUT_MAX_HEAD_DIM` decode is column-chunked
    (:func:`wide_chunk_decode_smem_bytes`) and this raises."""
    if not is_wide(head_dim) or chunked(head_dim):
        _refuse_cut(head_dim)
    return 2 if head_dim <= 512 else 1


def wide_decode_tile(kind) -> int:
    """Stored rows of a wide decode stage (``WdLayout::TILE``) for a pool
    kind: 32 bytes a column of K and of V (8 rows fp32, 16 of a 16-bit
    pool, 32 of int8 or int4), but 8 rows of fp8, whose float dots of more
    than one row a warp would not fit 128 registers at d 512."""
    code = _pool_kind(kind)
    eb = _POOL_KIND_BYTES[code]
    return 8 if code in (5, 6) else 32 // eb


def wide_decode_stages(head_dim: int, kind) -> int:
    """Stages of the wide decode kernel's ring (``WdLayout::STAGES``): as
    many K and V tiles (:func:`wide_decode_tile` rows of head_dim stored
    elements each) as fit 96 KB where two CTAs share an SM, 192 KB where
    one fills it, at most 8."""
    budget = (96 if wide_decode_ctas_per_sm(head_dim) == 2 else 192) * 1024
    stage = 2 * wide_decode_tile(kind) * head_dim * _POOL_KIND_BYTES[_pool_kind(kind)]
    return min(8, budget // stage)


def wide_decode_smem_bytes(head_dim: int, kind) -> int:
    """Shared memory of one CTA of the wide decode kernel (``csrc/wide.cuh``
    ``WdLayout::BYTES``; ``kind`` a name of :data:`POOL_KIND_NAMES` or its
    code): :func:`wide_decode_stages` stages of K and V tiles of
    :func:`wide_decode_tile` rows, each stage's K and V scales for quantized
    pools (two tokens a row for int4), WIDE_DECODE_PIDS page ids, q of the
    CTA's two heads in fp32, the 8 warps' running maxima and row sums for
    two heads, 8-byte aligned, and a full and an empty barrier a stage."""
    return _wide_decode_bytes(head_dim, kind, wide_decode_stages(head_dim, kind))


def _wide_decode_bytes(head_dim: int, kind, stages: int) -> int:
    code = _pool_kind(kind)
    tile = wide_decode_tile(code)
    scales = 2 * (2 if code == 4 else 1) * tile * 4 if code >= 3 else 0
    warps = WIDE_DECODE_THREADS // 32
    head = (2 * stages * tile * head_dim * _POOL_KIND_BYTES[code] + stages * scales
            + 4 * WIDE_DECODE_PIDS + 2 * head_dim * 4 + 2 * warps * 2 * 4)
    return -(-head // 8) * 8 + 16 * stages


def fits_ctas_per_sm(nbytes: int, ctas: int, static_bytes: int = 128) -> bool:
    """Whether ``ctas`` CTAs of ``nbytes`` of dynamic shared memory (and up
    to ``static_bytes`` of static, 128-byte aligned) fit on one SM
    together."""
    return ctas * (nbytes + static_bytes + SMEM_RESERVED_PER_CTA) <= SMEM_PER_SM


def default_block_kv(head_dim: int) -> int:
    """Keys a forward tile of the head dim's builds (``csrc/attn_fwd.cuh``
    ``key_tile``): 128, 64 at d 256, and in the wide builds 32
    (:data:`WIDE_FWD_KEYS`, the wide_wgmma kernel's tile), or above the cuts
    128 (:data:`WIDE_SCORES_TILE`, the score tiles of route
    ``"wide_scores"``)."""
    if chunked(head_dim):
        return WIDE_SCORES_TILE
    if is_wide(head_dim):
        return WIDE_FWD_KEYS
    return 64 if head_dim == 256 else 128


def default_block_kv_bwd(head_dim: int) -> int:
    """The head dim's builds' ``block_kv_bwd``: the keys the dQ sweep
    streams a stage (``csrc/attn_bwd.cuh`` ``stream_tile``), and the q rows
    of the dK/dV sweep but at d 256 (:func:`bwd_stream_rows`): 64, and 32 at
    d 256 and in the wide builds (:data:`WIDE_BWD_ROWS`, the 16-bit wide
    sweeps' tile), 64 again above the cuts (:data:`WIDE_SCORES_ROWS`, the
    rows a product pass of route ``"wide_scores"`` streams a stage)."""
    if chunked(head_dim):
        return WIDE_SCORES_ROWS
    if is_wide(head_dim):
        return WIDE_BWD_ROWS
    return 32 if head_dim == 256 else 64
