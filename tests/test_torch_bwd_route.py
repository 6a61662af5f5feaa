"""The backward sweeps' route rule, and their plain version at the tile edges.

``bwd_route`` fixes a backward sweep call's kernel from its types alone;
every (dtype, segment ids, head dim) combination is held against the table
of PERF.md: fp32 calls take the CUDA-core sweeps, every bf16/fp16 call
(with or without segment ids) the Hopper ``wgmma`` sweeps; at head dim 256
the same routes, with ALiBi, dropout and segment ids as at 64 and 128.

The plain backward (``attn_bwd_plain``, which CPU tensors take, and the
yardstick ``chip_smoke.py`` holds the kernels to on the card) is held
against the JAX package's ``flash_attention_backward`` in fp32, from the
same JAX forward's O and lse, at the shapes where the wgmma sweeps' tiling
has edges: 128-key / 128-row CTAs walking 64-row steps (lengths 63, 64,
65, 127, 128, 129, 257), bottom-right causal across lengths, windows about
one tile wide with the softcap, GQA 4:1 and 8:1, and ALiBi + dropout and
segment ids at one edge shape each.  JAX runs its Pallas routes in
interpret mode, as its own CPU tests do.  Tolerance: the reference's fp32
gradient ladder, dQ 9e-4 / dK 7e-4 / dV 7e-5, rtol 1e-5
(tests/test_backward.py:25).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

import flash_attention_dlrs_tpu as fa
from flash_attention_dlrs_tpu.ops import flash_attention_backward as jbackward
from flash_attention_dlrs_tpu.ops import flash_attention_forward as jforward
from flash_attention_dlrs_tpu_torch.ops import bwd_kernel as tbwd

ATOL = {"dq": 9e-4, "dk": 7e-4, "dv": 7e-5}
RTOL = 1e-5

# The route table of PERF.md: (dtype, segments) -> route, for d 64 and 128.
ROUTES = {
    (torch.float32, False): "fp32",
    (torch.float32, True): "fp32",
    (torch.bfloat16, False): "wgmma",
    (torch.bfloat16, True): "wgmma",
    (torch.float16, False): "wgmma",
    (torch.float16, True): "wgmma",
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype,segments", sorted(ROUTES, key=str))
def test_route_table(dtype, segments, d):
    route = tbwd.bwd_route(dtype, d, segments)
    assert route == ROUTES[dtype, segments]
    assert route in tbwd.ROUTE_CODES
    assert all(route in counts for counts in tbwd.BWD_ROUTE_LAUNCHES.values())


# d 256 without modes: both routes, like d 64 and 128
D256_ROUTES = {torch.float32: "fp32", torch.bfloat16: "wgmma", torch.float16: "wgmma"}


@pytest.mark.parametrize("dtype", sorted(D256_ROUTES, key=str))
def test_route_table_d256(dtype):
    route = tbwd.bwd_route(dtype, 256)
    assert route == D256_ROUTES[dtype]
    assert all(route in counts for counts in tbwd.BWD_ROUTE_LAUNCHES.values())


@pytest.mark.parametrize("mode", ["segments", "alibi", "dropout"])
@pytest.mark.parametrize("dtype", sorted(D256_ROUTES, key=str))
def test_route_refuses_the_modes_d256_lacks(dtype, mode):
    """ALiBi, dropout and segment ids at d 256, which the d256 builds once
    lacked, now take their dtype's route, as at d 64 and 128: nothing is
    refused at d 256 by mode."""
    route = tbwd.bwd_route(dtype, 256, **{mode: True})
    assert route == D256_ROUTES[dtype]
    assert route == tbwd.bwd_route(dtype, 128, **{mode: True})


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32), (torch.float32, 256),
                                     (torch.float64, 64), (torch.int8, 128)])
def test_route_refuses_what_no_kernel_takes(dtype, d):
    """A head dim no kernel is built for and a dtype none takes.  Every mode
    is built at d 256, so there what is refused is a dtype no kernel takes
    and a head dim past the widest kernel (320), with segment ids as
    well."""
    if d == 256:
        with pytest.raises(ValueError):
            tbwd.bwd_route(torch.float64, d, segments=True)
        with pytest.raises(ValueError):
            tbwd.bwd_route(dtype, 320, segments=True)
    else:
        with pytest.raises(ValueError):
            tbwd.bwd_route(dtype, d)


def test_route_refuses_head_dims_above_256_naming_queue_2():
    """Head dims above 256 run on the wide builds: on the wgmma cuts up to
    1024, on the score and product passes above; no multiple of 128 is
    refused, a head dim that is no kernel width is."""
    assert tbwd.bwd_route(torch.bfloat16, 384) == "wide_wgmma"
    assert tbwd.bwd_route(torch.bfloat16, 1152) == "wide_scores"
    with pytest.raises(ValueError, match="multiple of 128 above 256"):
        tbwd.bwd_route(torch.bfloat16, 1100)


def test_cpu_calls_count_no_route():
    before = {sweep: dict(counts) for sweep, counts in tbwd.BWD_ROUTE_LAUNCHES.items()}
    q, k, v, o, do = (torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16) for _ in range(5))
    lse = torch.zeros(1, 2, 40)
    tbwd.attn_bwd(q, k, v, o, lse, do, causal=True, sm_scale=0.125)
    assert tbwd.BWD_ROUTE_LAUNCHES == before


def _segments(b, n, seed):
    """[B, N] int32 segment ids: documents of 1..N/2 tokens end to end, so
    boundaries fall inside the 64-row steps and on their edges."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, n), np.int32)
    for row in ids:
        pos = doc = 0
        while pos < n:
            length = int(rng.integers(1, n // 2))
            row[pos:pos + length] = doc
            pos, doc = pos + length, doc + 1
    return ids


EDGES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, causal, window, softcap, mods)
    "n63": (1, 2, 1, 63, 63, 64, True, 0, 0.0, {}),
    "n64": (1, 2, 1, 64, 64, 128, True, 0, 0.0, {}),
    "n65_noncausal": (1, 2, 2, 65, 65, 64, False, 0, 0.0, {}),
    "n127": (1, 2, 1, 127, 127, 64, True, 0, 0.0, {}),
    "n128": (1, 2, 1, 128, 128, 128, True, 0, 0.0, {}),
    "n129": (1, 2, 1, 129, 129, 64, True, 0, 0.0, {}),
    "n257": (1, 2, 2, 257, 257, 64, True, 0, 0.0, {}),
    "cross_63_257": (1, 2, 1, 63, 257, 64, True, 0, 0.0, {}),
    "cross_129_385": (1, 2, 1, 129, 385, 64, True, 0, 0.0, {}),
    "cross_257_129": (1, 2, 1, 257, 129, 64, True, 0, 0.0, {}),
    "cross_1_257": (1, 4, 2, 1, 257, 128, True, 0, 0.0, {}),
    "window64_softcap_n300": (1, 2, 1, 300, 300, 64, True, 64, 25.0, {}),
    "window127_softcap_n300": (1, 2, 1, 300, 300, 64, True, 127, 25.0, {}),
    "window128_softcap_n300": (1, 2, 1, 300, 300, 128, True, 128, 25.0, {}),
    "window129_softcap_n300": (1, 2, 1, 300, 300, 64, True, 129, 25.0, {}),
    "gqa4_d64": (1, 8, 2, 130, 130, 64, True, 0, 0.0, {}),
    "gqa4_d128": (1, 8, 2, 130, 130, 128, True, 0, 0.0, {}),
    "gqa8_d64": (1, 8, 1, 129, 129, 64, False, 0, 0.0, {}),
    "gqa8_d128": (1, 8, 1, 129, 129, 128, True, 0, 0.0, {}),
    "alibi_dropout_n129": (1, 4, 2, 129, 129, 64, True, 0, 0.0,
                           {"alibi": True, "rate": 0.1, "seed": -7}),
    "segments_n257": (2, 2, 1, 257, 257, 64, True, 0, 0.0, {"segments": True}),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_plain_backward_matches_jax_at_tile_edges(name):
    b, hq, hkv, nq, nkv, d, causal, window, cap, mods = EDGES[name]
    rng = np.random.default_rng(len(name) + 100 * nq)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    do = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    slopes = fa.alibi_slopes_for(hq) if mods.get("alibi") else None
    ids = _segments(b, nq, nq) if mods.get("segments") else None
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window, alibi_slopes=slopes,
              dropout_rate=mods.get("rate", 0.0))
    jkw = dict(kw, logit_softcap=cap,
               dropout_seed=jnp.int32(mods["seed"]) if "seed" in mods else None,
               segment_ids=None if ids is None else jnp.asarray(ids))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jforward(jq, jk, jv, **jkw)
    want = jbackward(jq, jk, jv, o, jdo, lse, **jkw)
    seg = None if ids is None else torch.from_numpy(ids)
    got = tbwd.attn_bwd_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do), **kw, softcap=cap,
        dropout_seed=mods.get("seed", 0), q_seg=seg, kv_seg=seg)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    for grad, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL[grad], rtol=RTOL,
                                   err_msg=grad)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("segments", [False, True])
def test_sweep_builds_are_looked_up_at_call_time(monkeypatch, d, segments):
    """Each (head dim, segment ids) has its own build of each sweep, found
    by its module attribute when a call is made, so a check on the card
    can put a broken copy in its place (chip_smoke.py phase mutants)."""
    names = {tbwd.sweep_kernel(s, d, segments).symbol for s in ("attn_bwd_dkv", "attn_bwd_dq")}
    suffix = ("" if d == 128 else f"_d{d}") + ("_seg" if segments else "")
    assert names == {f"attn_bwd_dkv{suffix}", f"attn_bwd_dq{suffix}"}
    attr = "DKV" + ("" if d == 128 else f"_D{d}") + ("_SEG" if segments else "") + "_KERNEL"
    stand_in = object()
    monkeypatch.setattr(tbwd, attr, stand_in)
    assert tbwd.sweep_kernel("attn_bwd_dkv", d, segments) is stand_in
