"""The port's native (C++) bindings against the port's Python allocator and
the JAX package's bindings, on the CPU.

``runtime/_native.py`` builds ``native/src/*.cc`` through ``native/Makefile``
into ``flash_attention_dlrs_tpu_torch/_build/native/``;
``NativePageAllocator`` must answer call for call as the Python
``PageAllocator`` and the JAX package's ``NativePageAllocator`` do (ring
bookkeeping included), ``NativeTokenLoader`` / ``native_batches`` must give
the JAX loader's batches batch for batch, and ``native=True`` must raise
when the library cannot be built.  The JAX bindings are pointed at the
library the port built (the same sources): the JAX loader would otherwise
rebuild ``native/build/`` in this process while the JAX package's own
native tests may be building it in another.  The tests skip only where
``make`` or ``g++`` is absent; a failed build fails them.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.runtime import _native as jax_native
from flash_attention_dlrs_tpu.runtime import native_alloc as jax_alloc
from flash_attention_dlrs_tpu.runtime import native_data as jax_data
from flash_attention_dlrs_tpu.runtime.data import LoaderState as JLoaderState
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import TrainSpec, fit, params_from_jax
from flash_attention_dlrs_tpu_torch.runtime import _native, native_alloc, native_data
from flash_attention_dlrs_tpu_torch.runtime.data import LoaderState
from flash_attention_dlrs_tpu_torch.runtime.engine import DecodeEngine
from flash_attention_dlrs_tpu_torch.runtime.kv_cache import PageAllocator

SEQ = 16


@pytest.fixture(scope="module")
def lib():
    if not (shutil.which("make") and shutil.which("g++")):
        pytest.skip("make or g++ is not installed")
    path = _native.build()
    _native.load_lib()
    with pytest.MonkeyPatch.context() as mp:
        if jax_native._lib is None:  # load the JAX bindings from the port's build
            mp.setattr(jax_native, "_LIB_PATH", str(path))
            mp.setattr(jax_native, "_stale", lambda: False)
        assert jax_alloc.native_available() and jax_data.native_loader_available()
    return path


def _three(num_pages=16, page_size=128):
    return (PageAllocator(num_pages, page_size),
            native_alloc.NativePageAllocator(num_pages, page_size),
            jax_alloc.NativePageAllocator(num_pages, page_size))


def _same(results):
    first = results[0]
    for other in results[1:]:
        if isinstance(first, tuple):
            for a, b in zip(first, other):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(np.asarray(first), np.asarray(other))


def test_library_builds_beside_the_package(lib):
    assert lib == _native.library_path() and lib.exists()
    assert lib.parent == _native.BUILD_DIR / "native"
    assert lib.name.startswith("libfa_tpu_native-") and lib.suffix == ".so"


def test_build_runs_make_into_a_private_directory(lib, tmp_path, monkeypatch):
    """The Makefile's BUILD points into the port's build directory, never
    at native/build/; the result is moved to the hashed name."""
    calls = []
    run = _native.subprocess.run

    def spy(cmd, **kw):
        calls.append((cmd, kw["cwd"]))
        return run(cmd, **kw)

    monkeypatch.setattr(_native, "NATIVE_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native.subprocess, "run", spy)
    out = _native.build()
    (cmd, cwd), = calls
    build_arg = next(a for a in cmd if a.startswith("BUILD="))
    assert cwd == _native.NATIVE_DIR
    assert build_arg.startswith(f"BUILD={tmp_path / 'native'}/tmp-")
    assert out == _native.library_path() and out.exists()
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == [out.name]
    _native.build()  # present: nothing runs
    assert len(calls) == 1


def test_alloc_extend_free_cycle_call_for_call(lib):
    allocs = _three()
    for a in allocs:
        a.allocate("a", 300)
        a.allocate("b", 128)
    _same([len(a.free_pages) for a in allocs])
    for a in allocs:
        assert not a.can_allocate(13 * 128)
        with pytest.raises(MemoryError):
            a.allocate("c", 13 * 128)
        with pytest.raises(ValueError):
            a.allocate("a", 1)
        a.ensure_capacity("a", 700)
        a.seq_lengths["a"] = 700
    _same([a.page_indices_for(["a", "b"], 8) for a in allocs])
    _same([a.lengths_for(["a", "b", "missing"]) for a in allocs])
    for a in allocs:
        a.free("a")
        a.allocate("d", 500)
    _same([a.page_indices_for(["d", "b"], 8) for a in allocs])
    _same([len(a.free_pages) for a in allocs])
    _same([list(a.page_tables["d"]) for a in allocs])


def test_ref_counts_and_mixed_allocation_call_for_call(lib):
    allocs = _three()
    for a in allocs:
        a.allocate("p", 256)
    shared = list(allocs[0].page_tables["p"])
    for a in allocs:
        a.add_ref(shared)
        a.allocate_mixed("q", shared, 3 * 128)
        a.free("p")
    _same([a.ref_counts(shared) for a in allocs])
    _same([a.page_indices_for(["q"], 4) for a in allocs])
    for a in allocs:
        a.release(shared)
        a.free("q")
    _same([a.ref_counts(range(16)) for a in allocs])
    _same([len(a.free_pages) for a in allocs])
    for a in allocs:
        a.allocate("r", 16 * 128)  # the whole pool, in the same order
    _same([a.page_indices_for(["r"], 16) for a in allocs])


@pytest.mark.parametrize("ring", [(0, 0), (256, 0), (256, 128)],
                         ids=["plain", "rolling", "streaming"])
def test_decode_step_bookkeeping_call_for_call(lib, ring):
    """A serving run's sequence of bookkeeping calls (admissions, steps
    across the ring's wrap, a retirement and a new admission mid-run)."""
    wrap, sinks = ring
    allocs = _three(num_pages=32, page_size=64)
    resident = wrap + sinks
    for a in allocs:
        a.allocate("null", 1)
        for sid, t in (("x", 100), ("y", 300)):
            a.allocate(sid, min(t, resident) if wrap else t + 8)
            a.seq_lengths[sid] = t
    sids = ["x", "y"]
    for step in range(420):
        if step == 200:
            for a in allocs:
                a.free("x")
                a.allocate("z", resident if wrap else 64)
                a.seq_lengths["z"] = 30
            sids = ["z", "y"]
        if not wrap and step == 60:
            break
        outs = [tuple(np.array(o) for o in a.decode_step_bookkeeping(
            sids, 8, wrap, sinks)) for a in allocs]
        _same(outs)
    _same([a.lengths_for(sids) for a in allocs])


TCFG = TConfig.tiny(dtype=torch.float32, remat=False)
JCFG = JConfig.tiny(dtype=jnp.float32, remat=False)


@pytest.fixture(scope="module")
def models():
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), JCFG))
    rolling = dataclasses.replace(TCFG, window=128)
    return {"full": (params_from_jax(tree, TCFG, device="cpu"), TCFG),
            "rolling": (params_from_jax(tree, rolling, device="cpu"), rolling)}


@pytest.mark.parametrize("kind", ["full", "rolling"])
def test_engine_with_the_native_allocator(lib, models, kind):
    model, cfg = models[kind]
    prompts = [[5, 7, 11, 13, 17], list(range(1, 150))]

    def run(native):
        eng = DecodeEngine(model, cfg, num_pages=16, page_size=128, num_slots=2,
                           pages_per_seq=4, kv_dtype=torch.float32,
                           native_allocator=native, device="cpu")
        out = eng.generate(prompts, max_new_tokens=12)
        assert eng.stats()["allocator"] == ("native" if native else "python")
        assert eng.stats()["pages_free"] == 15
        return out

    assert run(True) == run(False)
    default = DecodeEngine(model, cfg, num_pages=4, page_size=128, kv_dtype=torch.float32,
                           device="cpu")
    assert default.stats()["allocator"] == "native"  # auto-detected


def _corpus(tmp_path, n_tokens=4001, dtype=np.uint16):
    path = tmp_path / "tokens.bin"
    np.arange(n_tokens, dtype=dtype).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed", [0, 7])
def test_loader_batch_for_batch_with_jax(lib, tmp_path, seed):
    path = _corpus(tmp_path, n_tokens=16 * 20 + 1)  # 20 windows, 5 batches an epoch
    kw = dict(seq_len=SEQ, batch_size=4, seed=seed)
    with native_data.NativeTokenLoader(path, **kw) as ld, \
            jax_data.NativeTokenLoader(path, **kw) as jld:
        run = [ld.next_batch() for _ in range(12)]
        want = [jld.next_batch() for _ in range(12)]
    for (b, s), (jb, js) in zip(run, want):
        np.testing.assert_array_equal(b, jb)
        assert b.dtype == np.int32 and b.shape == (4, SEQ + 1)
        assert (s.epoch, s.index) == (js.epoch, js.index)
    assert [s.epoch for _, s in run] == [0] * 5 + [1] * 5 + [2] * 2
    # resume from a cursor in the first epoch, and from the epoch's end
    for at, state in ((2, run[2][1]), (None, LoaderState(0, 20))):
        jstate = JLoaderState(state.epoch, state.index)
        got = native_data.native_batches(path, state=state, **kw)
        jgot = jax_data.native_batches(path, state=jstate, **kw)
        for _ in range(6):
            (b, s), (jb, js) = next(got), next(jgot)
            np.testing.assert_array_equal(b, jb)
            assert (s.epoch, s.index) == (js.epoch, js.index)
        if at is not None:
            np.testing.assert_array_equal(b, run[at + 6][0])
        got.close()
        jgot.close()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.uint32, np.int64])
def test_loader_widens_like_jax(lib, tmp_path, dtype):
    path = tmp_path / f"tok_{np.dtype(dtype).name}.bin"
    np.arange(200, dtype=dtype).tofile(path)
    got = native_data.native_batches(str(path), seq_len=8, batch_size=2, dtype=dtype)
    jgot = jax_data.native_batches(str(path), seq_len=8, batch_size=2, dtype=dtype)
    for _ in range(3):
        np.testing.assert_array_equal(next(got)[0], next(jgot)[0])
    got.close()
    jgot.close()


def test_loader_refusals_match_jax(lib, tmp_path):
    short = _corpus(tmp_path, n_tokens=40)
    for make in (lambda m: m.NativeTokenLoader(str(tmp_path / "nope.bin"), seq_len=8,
                                               batch_size=2),
                 lambda m: m.NativeTokenLoader(short, seq_len=SEQ, batch_size=4),
                 lambda m: m.NativeTokenLoader(short, seq_len=SEQ, batch_size=2,
                                               dtype=np.float32)):
        with pytest.raises(ValueError) as want:
            make(jax_data)
        with pytest.raises(ValueError) as got:
            make(native_data)
        assert str(got.value) == str(want.value)


def test_fit_reads_native_batches(lib, tmp_path):
    """fit takes native_batches as its batches, as an iterator and as a
    callable of the cursor, and trains on exactly the loader's batches."""
    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(0).integers(0, TCFG.vocab_size, 64 * 33 + 1,
                                      dtype=np.uint16).tofile(path)
    kw = dict(seq_len=32, batch_size=2, seed=3)
    spec = TrainSpec(learning_rate=1e-3, warmup_steps=1, total_steps=3)
    with native_data.NativeTokenLoader(path, **kw) as ld:
        drawn = [ld.next_batch() for _ in range(3)]
    a = fit(TCFG, native_data.native_batches(path, **kw), spec=spec, steps=3, device="cpu")
    b = fit(TCFG, iter(drawn), spec=spec, steps=3, device="cpu")
    c = fit(TCFG, lambda state: native_data.native_batches(path, state=state, **kw),
            spec=spec, steps=3, device="cpu")
    assert a["loader_state"] == b["loader_state"] == drawn[-1][1]
    for name, p in a["model"].state_dict().items():
        torch.testing.assert_close(p, b["model"].state_dict()[name], rtol=0, atol=0)
        torch.testing.assert_close(p, c["model"].state_dict()[name], rtol=0, atol=0)


def test_native_true_raises_when_the_build_fails(lib, tmp_path, monkeypatch, models):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "broken.cc").write_text("this is not C++\n")
    (tmp_path / "Makefile").write_text(
        "all:\n\t$(CXX) -shared -o $(BUILD)/libfa_tpu_native.so src/broken.cc\n")
    monkeypatch.setattr(_native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_native, "NATIVE_BUILD_DIR", tmp_path / "build")
    for module in (_native, native_alloc, native_data):
        monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(native_alloc, "_unavailable", False)
    with pytest.raises(RuntimeError, match="building the native library failed"):
        native_alloc.NativePageAllocator(8, 128)
    with pytest.raises(RuntimeError, match="building the native library failed"):
        native_alloc.make_page_allocator(8, 128, native=True)
    with pytest.raises(RuntimeError, match="building the native library failed"):
        native_data.NativeTokenLoader(_corpus(tmp_path), seq_len=SEQ, batch_size=2)
    model, cfg = models["full"]
    with pytest.raises(RuntimeError, match="building the native library failed"):
        DecodeEngine(model, cfg, num_pages=4, page_size=128, kv_dtype=torch.float32,
                     native_allocator=True, device="cpu")
    # auto-detection falls back to the Python allocator, and says so
    assert isinstance(native_alloc.make_page_allocator(8, 128), PageAllocator)
    assert native_alloc._unavailable  # remembered: no second build
    eng = DecodeEngine(model, cfg, num_pages=4, page_size=128, kv_dtype=torch.float32,
                       device="cpu")
    assert eng.stats()["allocator"] == "python"
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
