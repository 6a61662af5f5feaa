"""The forward kernel's route rule, and its plain version at the tile edges.

``fwd_route`` fixes a forward call's kernel from its types alone; every
(dtype, head dim, segment ids, fp8 V) combination is held against the table
of PERF.md: fp32 calls take the CUDA-core kernel, every bf16/fp16 call
(with or without segment ids, V of q's type or fp8) the Hopper ``wgmma``
kernel.

The plain forward (``attn_fwd_plain``, which CPU tensors take, and the
yardstick ``chip_smoke.py`` holds the kernels to on the card) is held
against the JAX package's ``flash_attention_forward`` in fp32 at the shapes
where the wgmma kernel's tiling has edges: 128-row q tiles and 128-key K/V
tiles (lengths 127, 128, 129, 257), bottom-right causal across lengths,
windows about one tile wide, GQA 4:1 and 8:1, and ALiBi and dropout at one
edge shape each.  JAX runs its Pallas routes in interpret mode, as its own
CPU tests do.  Tolerance: the repo's fp32 forward ladder, atol 1e-4 / rtol
1e-5 (tests/test_forward.py:21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

import flash_attention_dlrs_tpu as fa
from flash_attention_dlrs_tpu_torch.ops import fwd_kernel as tfwd

FWD = dict(atol=1e-4, rtol=1e-5)

# The route table of PERF.md: (dtype, segments, fp8 V) -> route, for d 64 and 128.
ROUTES = {
    (torch.float32, False, False): "fp32",
    (torch.float32, False, True): "fp32",
    (torch.float32, True, False): "fp32",
    (torch.float32, True, True): "fp32",
    (torch.bfloat16, False, False): "wgmma",
    (torch.bfloat16, False, True): "wgmma",
    (torch.bfloat16, True, False): "wgmma",
    (torch.bfloat16, True, True): "wgmma",
    (torch.float16, False, False): "wgmma",
    (torch.float16, False, True): "wgmma",
    (torch.float16, True, False): "wgmma",
    (torch.float16, True, True): "wgmma",
}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype,segments,fp8_v", sorted(ROUTES, key=str))
def test_route_table(dtype, segments, fp8_v, d):
    route = tfwd.fwd_route(dtype, d, segments, fp8_v)
    assert route == ROUTES[dtype, segments, fp8_v]
    assert route in tfwd.ROUTE_CODES


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32), (torch.float32, 256),
                                     (torch.float64, 64), (torch.int8, 128)])
def test_route_refuses_what_no_kernel_takes(dtype, d):
    """A head dim no kernel is built for and a dtype none takes.  Every mode
    is built at d 256, so there what is refused is a dtype no kernel takes
    and a head dim past the widest kernel (320), with segment ids as
    well."""
    if d == 256:
        with pytest.raises(ValueError):
            tfwd.fwd_route(torch.float64, d, segments=True)
        with pytest.raises(ValueError):
            tfwd.fwd_route(dtype, 320, segments=True)
    else:
        with pytest.raises(ValueError):
            tfwd.fwd_route(dtype, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_route_table_d256(dtype):
    """d 256 takes its dtype's route with or without segment ids, fp8 V,
    ALiBi or dropout, as d 64 and 128 do; d 512 takes its dtype's wide
    route, and past the wide cuts' 1024 the score and product passes
    (fp32 stays on wide_fp32); a head dim that is no kernel width raises."""
    route = "fp32" if dtype == torch.float32 else "wgmma"
    assert tfwd.fwd_route(dtype, 256) == route
    for kw in (dict(segments=True), dict(fp8_v=True), dict(alibi=True), dict(dropout=True)):
        assert tfwd.fwd_route(dtype, 256, **kw) == route
    assert tfwd.fwd_route(dtype, 512) == "wide_" + ("fp32" if route == "fp32" else "wgmma")
    assert tfwd.fwd_route(dtype, 1152) == ("wide_fp32" if route == "fp32" else "wide_scores")
    with pytest.raises(ValueError):
        tfwd.fwd_route(dtype, 1100)


def test_cpu_calls_count_no_route():
    before = dict(tfwd.ROUTE_LAUNCHES)
    q, k, v = (torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16) for _ in range(3))
    tfwd.attn_fwd(q, k, v, causal=True, sm_scale=0.125)
    assert tfwd.ROUTE_LAUNCHES == before


EDGES = {
    # name: (B, Hq, Hkv, Nq, Nkv, d, causal, window, mods)
    "n127": (1, 2, 1, 127, 127, 64, True, 0, {}),
    "n128": (1, 2, 1, 128, 128, 64, True, 0, {}),
    "n129": (1, 2, 1, 129, 129, 128, True, 0, {}),
    "n257": (1, 2, 2, 257, 257, 64, True, 0, {}),
    "cross_129_385": (1, 2, 1, 129, 385, 64, True, 0, {}),
    "cross_1_257": (1, 4, 2, 1, 257, 128, True, 0, {}),
    "window1_n300": (1, 2, 1, 300, 300, 64, True, 1, {}),
    "window127_n300": (1, 2, 1, 300, 300, 64, True, 127, {}),
    "window128_n300": (1, 2, 1, 300, 300, 64, True, 128, {}),
    "window129_n300": (1, 2, 1, 300, 300, 64, True, 129, {}),
    "gqa4_d64": (1, 8, 2, 130, 130, 64, True, 0, {}),
    "gqa4_d128": (1, 8, 2, 130, 130, 128, True, 0, {}),
    "gqa8_d64": (1, 8, 1, 129, 129, 64, False, 0, {}),
    "gqa8_d128": (1, 8, 1, 129, 129, 128, True, 0, {}),
    "alibi_n129_cross": (1, 4, 2, 129, 257, 64, True, 0, {"alibi": True}),
    "dropout_n257": (1, 2, 1, 257, 257, 64, True, 0, {"rate": 0.1, "seed": -7}),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_plain_forward_matches_jax_at_tile_edges(name):
    b, hq, hkv, nq, nkv, d, causal, window, mods = EDGES[name]
    rng = np.random.default_rng(len(name) + 100 * nq)
    q = rng.standard_normal((b, hq, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, nkv, d), dtype=np.float32)
    kw = dict(causal=causal, sm_scale=d ** -0.5, window=window,
              alibi_slopes=fa.alibi_slopes_for(hq) if mods.get("alibi") else None,
              dropout_rate=mods.get("rate", 0.0))
    oj, lj = fa.flash_attention_forward(
        *map(jnp.asarray, (q, k, v)), **kw,
        dropout_seed=jnp.int32(mods["seed"]) if "seed" in mods else None)
    ot, lt = tfwd.attn_fwd_plain(*map(torch.from_numpy, (q, k, v)), **kw,
                                 dropout_seed=mods.get("seed", 0))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **FWD)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FWD)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("segments", [False, True])
def test_builds_are_looked_up_at_call_time(monkeypatch, d, segments):
    """Each (head dim, segment ids) has a build of its own, found by its
    module attribute when a call is made."""
    suffix = ("" if d == 128 else f"_d{d}") + ("_seg" if segments else "")
    assert tfwd.fwd_kernel(d, segments).symbol == f"attn_fwd{suffix}"
    stand_in = object()
    monkeypatch.setattr(tfwd, f"FWD{suffix.upper()}_KERNEL", stand_in)
    assert tfwd.fwd_kernel(d, segments) is stand_in
