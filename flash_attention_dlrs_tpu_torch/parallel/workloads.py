"""Rank bodies that :func:`.launch.launch` runs: the sharded attention and
decode cases, the mesh train step and the tensor-parallel engine, each on
this rank's shards.

The tests, the examples and ``chip_smoke.py`` hand these functions to
:func:`.launch.launch` (a spawned rank imports them by name, so they live
in the package).  Each takes picklable inputs (numpy arrays, or a seed from
which every rank draws the same global tensors on its device), returns
picklable outputs (numpy arrays, plain numbers), and reports the kernel
launches it made (:func:`kernel_launches`; none on the CPU).  With
``check`` a case also runs the single-process op on the whole input on the
same device and holds this rank's shard of the result against it.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _cuda
from ..ops import bwd_kernel, fwd_kernel
from ..ops.decode import paged_decode_attention, quantize_kv_pages
from ..ops.flash_attention import flash_attention
from ..ops.quantization import QuantizedTensor
from .launch import all_gather
from .mesh import gather_tensor, make_mesh, rank_device, shard_tensor
from .sharded_attention import sharded_attention
from .sharded_decode import context_sharded_paged_decode, head_sharded_paged_decode, shard_pools

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# The backward's fp32 ladder (tests/test_backward.py:25) and its bf16 rule:
# each gradient's largest error within 2e-2 of its largest entry.
_FP32_GRAD_ATOL = (9e-4, 7e-4, 7e-5)
_LOWP_GRAD_REL = 2e-2


def kernel_launches() -> Dict[str, int]:
    """Every kernel's launches so far by entry symbol (``attn_fwd``,
    ``attn_bwd_dkv_d64``, ``paged_decode``, ...), and the forward's and each
    sweep's launches per route (``attn_fwd@wgmma``, ``attn_bwd_dq@fp32``)."""
    out = {k.symbol: k.launches for k in _cuda.KERNELS if k.launches}
    for route, n in fwd_kernel.ROUTE_LAUNCHES.items():
        if n:
            out[f"attn_fwd@{route}"] = n
    for sweep, routes in bwd_kernel.BWD_ROUTE_LAUNCHES.items():
        for route, n in routes.items():
            if n:
                out[f"{sweep}@{route}"] = n
    return out


def launches_between(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tensors(spec, dev):
    """A case's global inputs on ``dev``: numpy arrays as given, or
    ``{"seed", "shapes", "dtype"}`` drawn from a generator of that seed on
    ``dev`` (the same bits on every rank of one card); ``"uniform": True``
    makes q zeros and V ones instead (every probability equal, so O is the
    kept fraction over 1 − rate)."""
    if isinstance(spec, dict):
        dtype = _DTYPES[spec["dtype"]]
        shapes = spec["shapes"]
        if spec.get("uniform"):
            return [torch.zeros(shapes[0], device=dev, dtype=dtype),
                    torch.zeros(shapes[1], device=dev, dtype=dtype),
                    torch.ones(shapes[2], device=dev, dtype=dtype)]
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        return [torch.randn(s, generator=gen, device=dev, dtype=torch.float32).to(dtype)
                for s in shapes]
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in spec]


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype in (torch.bfloat16, torch.float16) else t).numpy()


def _held(got, want, grad: Optional[int]) -> dict:
    """``got`` against ``want`` at the kernel checks' limits: O at fp32's
    atol 1e-4 + rtol 1e-5 or, in half precision, max(2e-2, eps·|O|) per
    element; gradient ``grad`` (0, 1, 2: dQ, dK, dV) at the fp32 ladder or
    within 2e-2 of its largest entry."""
    a, b = got.float(), want.float()
    err = (a - b).abs()
    if grad is None:
        if got.dtype == torch.float32:
            ok = bool((err <= 1e-4 + 1e-5 * b.abs()).all())
        else:
            eps = torch.finfo(got.dtype).eps
            ok = bool((err <= torch.clamp(eps * b.abs(), min=2e-2)).all())
    elif got.dtype == torch.float32:
        ok = bool((err <= _FP32_GRAD_ATOL[grad] + 1e-5 * b.abs()).all())
    else:
        ok = float(err.max()) <= _LOWP_GRAD_REL * float(b.abs().max())
    ok &= bool(torch.isfinite(a).all())
    return {"max_abs_err": float(err.max()), "max_abs_ref": float(b.abs().max()), "ok": ok}


def attention_case(case: dict, dev) -> dict:
    """One sharded attention case on this rank.  ``case``: ``strategy`` and
    ``kw`` (of :func:`.sharded_attention.sharded_attention`), ``axes`` /
    ``names`` (the mesh), ``inputs`` (global q, k, v and, for ``grads``, dO:
    see :func:`_tensors`), ``q_spec`` / ``kv_spec`` (the shardings),
    ``zigzag``, ``seed`` (dropout; None without), ``repeat`` (run the
    forward again: ``bitwise`` says whether both runs agree bit for bit),
    ``gather`` (return the gathered O and gradients, default True) and
    ``check`` (hold this rank's shards against the single-process op on the
    whole input: ``held``, per output).  Returns this rank's launches and
    seconds besides, and ``mean_o``, the mean of its O shard."""
    mesh = make_mesh(case["axes"], case["names"])
    tensors = _tensors(case["inputs"], dev)
    zz = case.get("zigzag", False)
    q_spec, kv_spec = case["q_spec"], case["kv_spec"]
    specs = (q_spec, kv_spec, kv_spec)
    q, k, v = (shard_tensor(t, mesh, s, zigzag=zz) for t, s in zip(tensors[:3], specs))
    grads = case.get("grads", False)
    if grads:
        for t in (q, k, v):
            t.requires_grad_(True)
    fn = sharded_attention(mesh, case["strategy"], **case.get("kw", {}))
    extra = () if case.get("seed") is None else (case["seed"],)
    _sync(dev)
    before, t0 = kernel_launches(), time.perf_counter()
    o = fn(q, k, v, *extra)
    if grads:
        o.backward(shard_tensor(tensors[3], mesh, q_spec, zigzag=zz))
    _sync(dev)
    rec = {"seconds": time.perf_counter() - t0,
           "launches": launches_between(before, kernel_launches()),
           "mean_o": float(o.detach().float().mean())}
    outs = [o.detach()] + ([q.grad, k.grad, v.grad] if grads else [])
    out_specs = [q_spec] + (list(specs) if grads else [])
    if case.get("repeat"):
        with torch.no_grad():
            again = fn(q, k, v, *extra)
        rec["bitwise"] = bool(torch.equal(again, outs[0]))
        rec["finite"] = bool(torch.isfinite(outs[0]).all())
    if case.get("check"):
        kw = {key: val for key, val in case.get("kw", {}).items() if key in ("causal", "sm_scale")}
        if case["strategy"] == "zigzag":
            kw["causal"] = True
        whole = [t.clone().requires_grad_(grads) for t in tensors[:3]]
        ref = flash_attention(*whole, **kw)
        want = [ref.detach()]
        if grads:
            ref.backward(tensors[3])
            want += [t.grad for t in whole]
        rec["held"] = [_held(a, shard_tensor(b, mesh, s, zigzag=zz), None if i == 0 else i - 1)
                       for i, (a, b, s) in enumerate(zip(outs, want, out_specs))]
    if case.get("gather", True):
        rec["out"] = [_np(gather_tensor(t, mesh, s, zigzag=zz)) for t, s in zip(outs, out_specs)]
    return rec


def attention_cases(cases: List[dict], device: str = "cpu") -> Dict[str, dict]:
    """Every case of ``cases`` (:func:`attention_case`) on this rank, by
    ``name``."""
    dev = rank_device(device)
    return {case["name"]: attention_case(case, dev) for case in cases}


def _quantized(kind, pool):
    return quantize_kv_pages(pool, torch.int8 if kind == "int8" else kind)


def decode_case(case: dict, dev) -> dict:
    """One sharded paged decode case.  ``case``: ``layout`` "head" (pools
    sharded on kv heads over ``model``, batch over ``data``) or "context"
    (each rank's own pool slice, lengths and tables: ``lengths`` [B, n] and
    ``tables`` [B, n, pages] give every rank's), ``axes`` / ``names``,
    ``inputs`` (global q [B, Hq, d], K and V pools), ``kind`` ("int8" /
    "int4" quantize the pools; anything else takes them as they are),
    ``lengths``, ``tables``.  With ``check`` (``global_lengths`` /
    ``global_tables`` describe the whole context) the result is held
    against the single-process decode: 1e-4 + eps·(|O| + P|V|) per element
    in half precision, P|V| the decode over |V| (each rank's partial O is
    rounded to q's dtype before the merge), atol 1e-4 in fp32 (``held``).
    Returns the gathered O (``gather``), this rank's launches and
    seconds."""
    mesh = make_mesh(case["axes"], case["names"])
    q, kp, vp = _tensors(case["inputs"], dev)
    kind = case["kind"]
    if kind in ("int8", "int4"):
        kp, vp = _quantized(kind, kp), _quantized(kind, vp)
    lengths = torch.as_tensor(np.asarray(case["lengths"]), dtype=torch.int32, device=dev)
    tables = torch.as_tensor(np.asarray(case["tables"]), dtype=torch.int32, device=dev)
    if case["layout"] == "head":
        fn = head_sharded_paged_decode(mesh)
        args = (shard_tensor(q, mesh, ("data", "model", None)),
                shard_pools(kp, mesh, "model", 0), shard_pools(vp, mesh, "model", 0),
                shard_tensor(lengths, mesh, ("data",)),
                shard_tensor(tables, mesh, ("data", None)))
    else:
        fn = context_sharded_paged_decode(mesh)
        c = mesh.index("context")
        args = (q, shard_pools(kp, mesh, "context", 1), shard_pools(vp, mesh, "context", 1),
                lengths[:, c].contiguous(), tables[:, c].contiguous())
    _sync(dev)
    before, t0 = kernel_launches(), time.perf_counter()
    o = fn(*args)
    _sync(dev)
    rec = {"seconds": time.perf_counter() - t0,
           "launches": launches_between(before, kernel_launches())}
    if case["layout"] == "head":
        o = gather_tensor(o, mesh, ("data", "model", None))
    if case.get("check"):
        g_len, g_tbl = (torch.as_tensor(np.asarray(case[key]), dtype=torch.int32, device=dev)
                        for key in ("global_lengths", "global_tables"))
        want = paged_decode_attention(q, kp, vp, g_len, g_tbl).float()
        err = (o.float() - want).abs()
        if q.dtype == torch.float32:
            limit = torch.full_like(want, 1e-4)
        else:
            abs_v = (QuantizedTensor(vp.values.abs(), vp.scales)
                     if isinstance(vp, QuantizedTensor) else vp.abs())
            spread = paged_decode_attention(q, kp, abs_v, g_len, g_tbl).float()
            limit = 1e-4 + torch.finfo(q.dtype).eps * (want.abs() + spread)
        rec["held"] = [{"max_abs_err": float(err.max()),
                        "worst_err_over_limit": float((err / limit).max()),
                        "ok": bool((err <= limit).all() and torch.isfinite(o).all())}]
    if case.get("gather", True):
        rec["out"] = [_np(o)]
    return rec


def decode_cases(cases: List[dict], device: str = "cpu") -> Dict[str, dict]:
    """Every case of ``cases`` (:func:`decode_case`) on this rank, by
    ``name``."""
    dev = rank_device(device)
    return {case["name"]: decode_case(case, dev) for case in cases}


def save_weights(tree: dict, directory: str) -> str:
    """Write a JAX-layout tree of numpy weights as one ``.npy`` file a leaf
    (``layers.3.wq.npy``) under ``directory``, for :func:`load_weights`;
    returns ``directory``.  A full-width model then crosses to its ranks
    through the page cache, not a pickle."""
    import os

    for name, leaf in _flat(tree):
        np.save(os.path.join(directory, name + ".npy"), leaf)
    return directory


def _flat(tree: dict, prefix=""):
    for key, val in tree.items():
        if key == "layers":
            for i, layer in enumerate(val):
                yield from _flat(layer, f"{prefix}layers.{i}.")
        else:
            yield prefix + key, val


def load_weights(directory: str) -> dict:
    """The tree :func:`save_weights` wrote, its leaves memory-mapped (a
    rank reads only the slices it keeps)."""
    import os

    tree: dict = {}
    for file in sorted(os.listdir(directory)):
        parts = file[:-len(".npy")].split(".")
        leaf = np.load(os.path.join(directory, file), mmap_mode="r")
        if parts[0] == "layers":
            layers = tree.setdefault("layers", [])
            while len(layers) <= int(parts[1]):
                layers.append({})
            layers[int(parts[1])][parts[2]] = leaf
        else:
            tree[parts[0]] = leaf
    return tree


def _weights(cfg, params):
    """The JAX-layout weights: ``params`` itself (numpy leaves), the seeded
    ``init_params_numpy`` for an int, or the tree :func:`save_weights` wrote
    for a directory (so that a full-width model is not pickled to a
    rank)."""
    from ..models import init_params_numpy

    if isinstance(params, int):
        return init_params_numpy(cfg, params)
    return load_weights(params) if isinstance(params, str) else params


def _pairs(got: dict, want: dict, prefix=""):
    """(name, got leaf, want leaf) over two JAX-layout trees, by key."""
    for key, val in want.items():
        if key == "layers":
            for i, (lg, lw) in enumerate(zip(got["layers"], val)):
                yield from _pairs(lg, lw, f"layers.{i}.")
        else:
            yield prefix + key, np.asarray(got[key], np.float32), np.asarray(val, np.float32)


def weight_gaps(got: dict, want: dict, limit: float) -> dict:
    """Two JAX-layout trees of weights compared leaf by leaf: the worst
    leaf's max |got − want| / std(want) and which leaf, the largest absolute
    gap, and the fraction of all weights whose gap passes ``limit`` x their
    leaf's std."""
    worst, where, top, past, total = 0.0, None, 0.0, 0, 0
    for name, a, b in _pairs(got, want):
        gap = np.abs(a - b)
        std = max(float(b.std()), 1e-30)
        if float(gap.max()) / std > worst:
            worst, where = float(gap.max()) / std, name
        top = max(top, float(gap.max()))
        past += int((gap > limit * std).sum())
        total += gap.size
    return {"gap_over_std": worst, "leaf": where, "max_abs_gap": top,
            "frac_past_limit": past / total, "limit_x_std": limit}


def train_run(cfg, params, tokens, axes, names=("data", "model"), *, kind: str = "step",
              steps: int = 1, seeds=None, accum_steps: int = 1, learning_rate: float = 3e-4,
              spec=None, gather: bool = True, reference: Optional[str] = None,
              gap_limit: float = 1e-3, device: str = "cpu") -> dict:
    """``steps`` mesh train steps from the JAX-layout weights ``params``
    (numpy, an int seed or a directory: :func:`_weights`) on the global batch
    ``tokens`` (numpy [B, N+1], every step the same unless a list is
    given): ``kind`` "step" (make_train_step), "accum"
    (make_accum_train_step with ``accum_steps``) or "fit" (fit with
    ``spec``, a TrainSpec).  Returns the losses, the updated weights
    gathered whole on rank 0 (``gather``; numpy, the JAX layout), this
    rank's launches and seconds per step.  Then, with ``reference``, the
    same steps run in one process on the rank's device, from the same
    weights: "losses" on rank 0, which reports their losses
    (``ref_losses``); "weights" on every rank, which also reports how far
    its own shard of the updated weights lies from the same shard of the
    single process's (``weight_gaps`` at ``gap_limit``)."""
    from ..models import params_to_numpy
    from ..models.train import make_train_state, make_train_step, param_shardings, shard_params
    from ..models.trainer import fit, make_accum_train_step

    dev = rank_device(device)
    mesh = make_mesh(axes, names)
    weights = _weights(cfg, params)
    batches = tokens if isinstance(tokens, list) else [tokens] * steps
    seeds = seeds if seeds is not None else [None] * steps
    before = kernel_launches()
    times, losses = [], []

    def run(run_mesh, sink, clock=None):
        if kind == "fit":
            def stream(_state):
                for t in batches:
                    yield t, None
            return fit(cfg, stream, spec=spec, steps=steps, mesh=run_mesh, params=weights,
                       device=dev, on_step=lambda i, loss: sink.append(float(loss)))["model"]
        model, opt_state, optimizer = make_train_state(
            cfg, run_mesh, params=weights, device=dev, learning_rate=learning_rate)
        step = (make_accum_train_step(cfg, optimizer, run_mesh, accum_steps=accum_steps)
                if kind == "accum" else make_train_step(cfg, optimizer, run_mesh))
        for t, s in zip(batches, seeds):
            _sync(dev)
            t0 = time.perf_counter()
            sink.append(float(step(model, opt_state, torch.from_numpy(np.asarray(t)).to(dev), s)))
            if clock is not None:
                clock.append(time.perf_counter() - t0)
        return model

    model = run(mesh, losses, times)
    out = {"losses": losses, "launches": launches_between(before, kernel_launches()),
           "step_seconds": times}
    local = params_to_numpy(model) if gather or reference == "weights" else None
    if gather:
        whole = _gather_tree(local, param_shardings(local, mesh, n_kv_heads=cfg.n_kv_heads), mesh)
        out["params"] = whole if mesh.rank == 0 else None
    del model
    if reference == "weights" or (reference == "losses" and mesh.rank == 0):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["ref_losses"] = []
        ref = run(None, out["ref_losses"])
        if reference == "weights":
            ref_local = shard_params(params_to_numpy(ref), mesh, n_kv_heads=cfg.n_kv_heads)
            out["weight_gaps"] = weight_gaps(local, ref_local, gap_limit)
    return out


def _gather_tree(tree, specs, mesh):
    def leaf(a, spec):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return gather_tensor(t, mesh, spec).numpy()

    out = {k: leaf(tree[k], specs[k]) for k in tree if k != "layers"}
    out["layers"] = [{k: leaf(layer[k], spec[k]) for k in layer}
                     for layer, spec in zip(tree["layers"], specs["layers"])]
    return out


def engine_run(cfg, params, prompts, new_tokens: int, axes, names=("model",), *,
               engine_kw: Optional[dict] = None, runs: int = 1, device: str = "cpu",
               calls=("generate",)) -> dict:
    """A tensor-parallel DecodeEngine from the whole JAX-layout weights
    ``params`` (numpy, an int seed or a directory: :func:`_weights`), of which this
    rank keeps its slice.  Each of ``calls`` ("generate", "burst" for
    generate(burst=4), "fused" for generate_fused) on ``prompts``, ``runs``
    times.  Returns this rank's tokens per call, its launches, the seconds
    of each run, its pools' kv heads and whether every rank's tokens are
    equal (``all_ranks_equal``)."""
    from ..models import params_from_jax
    from ..models.train import shard_params
    from ..runtime import DecodeEngine

    dev = rank_device(device)
    mesh = make_mesh(axes, names)
    local = shard_params(_weights(cfg, params), mesh, n_kv_heads=cfg.n_kv_heads)
    engine = DecodeEngine(params_from_jax(local, cfg, device=dev, mesh=mesh), cfg, mesh=mesh,
                          device=dev, **(engine_kw or {}))
    del local
    out = {"tokens": {}, "seconds": {}}
    before = kernel_launches()
    for call in calls:
        for _ in range(runs):
            _sync(dev)
            t0 = time.perf_counter()
            if call == "generate":
                toks = engine.generate(prompts, max_new_tokens=new_tokens)
            elif call == "burst":
                toks = engine.generate(prompts, max_new_tokens=new_tokens, burst=4)
            else:
                toks = engine.generate_fused(prompts, max_new_tokens=new_tokens)
            _sync(dev)
            out["seconds"].setdefault(call, []).append(time.perf_counter() - t0)
            out["tokens"][call] = [list(map(int, t)) for t in toks]
    out["launches"] = launches_between(before, kernel_launches())
    out["pool_heads"] = int(engine.pools.k[0].shape[0])
    # a digest of the tokens this rank saw, to hold every rank's equal
    flat = np.array([t for call in calls for seq in out["tokens"][call] for t in seq], np.int64)
    digest = torch.tensor([len(flat), int(np.sum(flat * np.arange(1, len(flat) + 1)) % 2 ** 61)])
    out["all_ranks_equal"] = all(
        torch.equal(digest, other) for other in all_gather(digest, mesh, names[-1]))
    return out


def models_suite(train_cases: List[dict], engine_cases=(), device: str = "cpu") -> dict:
    """Every train run of ``train_cases`` (keyword arguments of
    :func:`train_run`, by ``name``), then every engine run of
    ``engine_cases`` (keyword arguments of :func:`engine_run`, by
    ``name``), on this rank."""
    out = {}
    for case in list(train_cases) + list(engine_cases):
        kw = dict(case)
        name = kw.pop("name")
        out[name] = (engine_run if "prompts" in kw else train_run)(**kw, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out
