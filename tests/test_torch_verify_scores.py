"""Paged verify above head dim 1024 in the PyTorch port, against the JAX package.

Above 1024 the port runs bf16 / fp16 ``paged_verify_attention`` on the card
as the score pass and the product pass of route ``wide_scores`` over paged
rows (``csrc/wide_scores.cuh``, built as ``csrc/paged_verify_wide.cu``;
:mod:`flash_attention_dlrs_tpu_torch.ops.wide_scores` ``verify_call``), its
key splits merged by ``wide_combine_kernel``.  Here, on CPU tensors, the
passes' plain versions run, composed as the card runs them (q folded and
scaled, each wave's score pass then its product pass over each key split,
the splits merged).  Same seeded numpy inputs at pool head dim 1152 go
through the JAX package's ``paged_verify_attention`` in Pallas interpret
mode, as its own CPU tests run it (one ``jax.jit`` a case).  Cases cover
bf16, int8, int4 and e4m3 pools, pages of 16 and 128 tokens, softcap,
ALiBi, GQA 2:1, a partial chunk with front padding, two row tiles, one key
split and several.

Tolerances: against JAX ``tests/test_torch_wide_heads.py``'s ``BF16_TOL``
(atol 2^-8, rtol 2^-7 of |O|: bf16 q and O) plus 2^-7 x P|V| (P|V| is
``paged_verify_plain`` over |V|): both sides round P to bf16, and where P
sits on a few keys (ALiBi's steep slopes) one rounding apart moves O by a
bf16 unit of P|V|, which can be far above |O| where V's signs cancel; the
card's own check of the verify kernels adds the same term
(``chip_smoke.paged_errors``).  Against ``paged_verify_plain``, that check
itself: 1e-4 + eps x (|O| + P|V|).  Several waves: bit for bit one wave.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_dlrs_tpu.ops import decode as jdec
from flash_attention_dlrs_tpu_torch import geometry as geo
from flash_attention_dlrs_tpu_torch.ops import decode as tdec
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd
from flash_attention_dlrs_tpu_torch.ops import wide_scores as ws
from flash_attention_dlrs_tpu_torch.ops.quantization import (
    Int4QuantizedTensor, QuantizedTensor, unpack_int4_rows,
)
from test_torch_wide_heads import BF16_TOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

D = 1152
KINDS = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
         "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
# name: (pool kind, page size, pages a sequence, T, Hq, Hkv, lengths, softcap,
# ALiBi, key splits)
CASES = {
    "bf16_page16_softcap_gqa_front_padding": ("bf16", 16, 12, 6, 4, 2, [4, 150], 30.0, False, 3),
    "int8_page128_alibi_two_row_tiles": ("int8", 128, 2, 70, 4, 2, [200, 90], 0.0, True, 2),
    "int4_page16_softcap_alibi": ("int4", 16, 12, 5, 2, 2, [170], 20.0, True, 4),
    "e4m3_page128_gqa": ("e4m3", 128, 2, 9, 4, 2, [130, 256], 0.0, False, 2),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """Seeded numpy inputs of a case on both sides: (JAX args, torch args,
    softcap, ALiBi slopes or None, key splits, the rows that see a key)."""
    kind, ps, pps, t, hq, hkv, lengths, cap, alibi, splits = CASES[name]
    b = len(lengths)
    rng = np.random.default_rng(len(name))
    num_pages = b * pps + 2
    q = rng.standard_normal((b, hq, t, D), dtype=np.float32)
    kp, vp = (rng.standard_normal((hkv, num_pages, ps, D), dtype=np.float32) for _ in range(2))
    tbl = rng.permutation(num_pages)[: b * pps].reshape(b, pps).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    if kind == "bf16":
        jk, jv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        tk, tv = torch.from_numpy(kp).bfloat16(), torch.from_numpy(vp).bfloat16()
    else:
        jd, td = KINDS[kind]
        jk, jv = (jdec.quantize_kv_pages(jnp.asarray(a), jd) for a in (kp, vp))
        tk, tv = (tdec.quantize_kv_pages(torch.from_numpy(a), td) for a in (kp, vp))
    slopes = tuple(0.5 ** (h + 1) for h in range(hq)) if alibi else None
    seen = ((lens[:, None] - (t - 1) + np.arange(t)[None, :]) > 0)[:, None, :, None]
    return ((jq, jk, jv, jnp.asarray(lens), jnp.asarray(tbl)),
            (tq, tk, tv, torch.from_numpy(lens), torch.from_numpy(tbl)), cap, slopes, splits,
            seen)


def _composed(tq, tk, tv, lens, tbl, cap, slopes, splits):
    """The passes' plain versions composed as the card runs them."""
    return ws.verify_call(tq, tdec._Pools(tk, tv), lens, tbl,
                          scale=tdec._scale_in(D ** -0.5, tq.dtype), splits=splits,
                          softcap=cap, alibi_slopes=slopes)


def _abs_v(k, v):
    """(K, |V|) of the same logical values, in a kind the plain version
    takes (int4 as int8 payloads with the same scales)."""
    if torch.is_tensor(v):
        return k, v.abs()
    if isinstance(v, Int4QuantizedTensor):
        k = QuantizedTensor(unpack_int4_rows(k.values).to(torch.int8), k.scales)
        v = QuantizedTensor(unpack_int4_rows(v.values).to(torch.int8), v.scales)
    return k, QuantizedTensor(v.values.float().abs().to(v.values.dtype), v.scales)


def _spread(tq, tk, tv, lens, tbl, cap, slopes):
    """P|V|: paged_verify_plain over |V| (fp32)."""
    return tdec.paged_verify_plain(tq, *_abs_v(tk, tv), lens, tbl, logit_softcap=cap,
                                   alibi_slopes=slopes).float()


@pytest.mark.parametrize("name", sorted(CASES))
def test_composed_passes_match_jax(name):
    """The composed passes at one key split and at the case's several
    against the JAX package's paged_verify_attention (interpret mode) on the
    same inputs, within BF16_TOL plus a bf16 unit of P|V| (the module
    docstring says why); rows that see no key (front padding) are zero."""
    jargs, targs, cap, slopes, splits, seen = _inputs(name)
    want = np.asarray(jax.jit(functools.partial(
        jdec.paged_verify_attention, logit_softcap=cap,
        alibi_slopes=None if slopes is None else list(slopes)))(*jargs), np.float32)
    limit = (BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(want)
             + 2 ** -7 * _spread(*targs, cap, slopes).numpy())
    for n in (1, splits):
        got = _composed(*targs, cap, slopes, n)
        assert got.dtype == torch.bfloat16 and got.shape == targs[0].shape
        got = got.float().numpy()
        assert (np.abs(np.where(seen, got - want, 0)) <= limit).all()
        assert (np.where(seen, 0, got) == 0).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_composed_passes_match_paged_verify_plain(name):
    """The composed passes against paged_verify_plain (the function's one
    plain version) within the card's check of the verify kernels: both
    round P times the V scale to bf16, the passes against the merged lse and
    the plain version against the row's max."""
    _, (tq, tk, tv, lens, tbl), cap, slopes, splits, _ = _inputs(name)
    want = tdec.paged_verify_plain(tq, tk, tv, lens, tbl, logit_softcap=cap,
                                   alibi_slopes=slopes).float()
    spread = _spread(tq, tk, tv, lens, tbl, cap, slopes)
    limit = 1e-4 + torch.finfo(torch.bfloat16).eps * (want.abs() + spread)
    for n in (1, splits):
        got = _composed(tq, tk, tv, lens, tbl, cap, slopes, n).float()
        assert bool(((got - want).abs() <= limit).all())


@pytest.mark.parametrize("splits", [1, 3])
def test_waves_are_bitwise_one_wave(splits, monkeypatch):
    """A lowered scratch cap runs the call one tile a wave (its 8 tiles: two
    sequences, two kv heads, two row tiles), bit for bit the call in one
    wave."""
    _, (tq, tk, tv, lens, tbl), cap, slopes, _, _ = _inputs("int8_page128_alibi_two_row_tiles")
    one = _composed(tq, tk, tv, lens, tbl, cap, slopes, splits)
    n_keys = tbl.shape[1] * tk.values.shape[2]
    monkeypatch.setattr(geo, "WIDE_SCORES_SCRATCH_BYTES", geo.wide_scores_tile_bytes(n_keys, False))
    assert ws.verify_waves(2, 2, 140, n_keys) == [(f, f + 1) for f in range(8)]
    assert torch.equal(_composed(tq, tk, tv, lens, tbl, cap, slopes, splits), one)


def test_route_planner_and_codes():
    """Above 1024 bf16 / fp16 verify names route ``wide_scores`` (code 6,
    the forward's) on every pool kind; ``wide_chunk`` (code 5) is gone; the
    product pass's CTAs and the key splits at the serving-d2048 chunk (B1
    Hq1 Hkv1 T256, 17 pages of 128, 132 SMs: 2 row tiles x 8 column chunks
    a split, 9 splits of 2 key tiles) and whole key tiles at every count."""
    for d in (1152, 2048, 8192):
        for dtype in (torch.bfloat16, torch.float16):
            for pool in (dtype, torch.int8, "int4", torch.float8_e4m3fn, torch.float8_e5m2):
                assert tdec.verify_route(dtype, pool, 16, d, alibi=True) == "wide_scores"
        assert tdec.verify_route(torch.float32, torch.int8, 16, d) == "wide_fp32"
        assert tdec.paged_kernels(d, torch.bfloat16)[1] is tdec.VERIFY_WIDE_KERNEL
    assert tdec.verify_route(torch.bfloat16, torch.bfloat16, 128, 1024) == "wide_wgmma"
    assert tdec.VERIFY_ROUTE_CODES["wide_scores"] == tfwd.ROUTE_CODES["wide_scores"] == 6
    assert "wide_chunk" not in tdec.VERIFY_ROUTE_CODES and "wide_chunk" not in tfwd.ROUTE_CODES
    assert 5 not in tdec.VERIFY_ROUTE_CODES.values()
    assert tdec.verify_ctas_per_split("wide_scores", 256, 2048) == 2 * 8
    assert tdec.verify_ctas_per_split("wide_scores", 130, 1152) == 2 * 5
    assert tdec.verify_splits("wide_scores", 1, 1, 1, 256, 2048, 17, 128, 132) == 9
    assert ws.verify_split_tiles(17 * 128, 9) == 2
    for n_keys in (200, 2176, 16 * 137):
        n_kt = ws.n_tiles(n_keys)
        for asked in (1, 2, 5, 9, 100):
            splits = tdec.scores_splits(n_keys, asked)
            per = ws.verify_split_tiles(n_keys, splits)
            assert 1 <= splits <= min(asked, n_kt, tdec.VERIFY_MAX_SPLITS)
            assert (splits - 1) * per < n_kt <= splits * per


def test_layouts_scratch_and_key_ranges():
    """The verify passes' shared memory (the forward's score layout with the
    keys' K scales in place of segment ids; the forward product's stages
    with each stage's 64 V scales), a wave's scratch and the key tiles a
    row tile sees: none past the last row's horizon, none for rows that see
    no key."""
    assert geo.wide_scores_smem_bytes("verify_scores") == 4 * 32768 + 512 + 64 + 1024
    assert geo.wide_scores_smem_bytes("verify_product") == 3 * 65536 + 768 + 48 + 1024
    assert geo.wide_scores_smem_bytes("verify_scores") == geo.wide_scores_smem_bytes("fwd_scores")
    optin = geo.current_geometry("cpu").smem_per_block_optin
    assert all(geo.wide_scores_smem_bytes(k) <= optin for k in ("verify_scores", "verify_product"))
    # T 256, G 1: row tiles of tokens 0..127 and 128..255 at length 2048
    assert ws.verify_key_hi([2048, 100, 0], 256, 256, 1, 2176) == [[1920, 2048], [0, 100], [0, 0]]
    mask = ws.verify_scratch_mask((0, 2), [[1920, 2048]], 1, 256, 2176, "cpu")
    assert mask.shape == (256, 17 * 128) and mask[0].sum() == 1920
    assert mask[128:].sum() == 128 * 2048
    s, stats = ws.verify_scratch((3, 5), 2176, "cpu")
    assert s.shape == (256, 17 * 128) and stats.shape == (256, 17, 2)


def test_wrappers_take_the_plain_passes_on_the_cpu():
    """On CPU tensors each pass's wrapper runs its plain version (no launch
    counted), and paged_verify_attention its plain version, whatever the
    route on the card."""
    _, (tq, tk, tv, lens, tbl), cap, slopes, splits, _ = _inputs("e4m3_page128_gqa")
    before = [k.launches for k in (ws.VERIFY_SCORES_KERNEL, ws.VERIFY_PRODUCT_KERNEL,
                                   ws.VERIFY_COMBINE_KERNEL)]
    _composed(tq, tk, tv, lens, tbl, cap, slopes, splits)
    assert before == [k.launches for k in (ws.VERIFY_SCORES_KERNEL, ws.VERIFY_PRODUCT_KERNEL,
                                           ws.VERIFY_COMBINE_KERNEL)]
    kw = dict(logit_softcap=cap, alibi_slopes=slopes)
    assert torch.equal(tdec.paged_verify_attention(tq, tk, tv, lens, tbl, **kw),
                       tdec.paged_verify_plain(tq, tk, tv, lens, tbl, **kw))
