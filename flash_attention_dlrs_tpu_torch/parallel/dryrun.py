"""Multi-rank dry run, PyTorch counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``: on tiny shapes, every rank of a group runs

1. a dp × tp training step with attention dropout 0.1;
2. ring attention over a context axis, forward and backward, with dropout;
3. the zigzag ring against the dense oracle (error under 2e-4) and its
   backward;
4. context-sharded paged decode;
5. a tensor-parallel (tp 2) DecodeEngine generating on sharded KV pools.

``python -m flash_attention_dlrs_tpu_torch.parallel.dryrun --world 4
--device cpu`` runs it on 4 gloo ranks of the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from .._cuda import resolve_device
from ..ops.reference import reference_attention
from .launch import launch
from .mesh import gather_tensor, make_mesh, rank_device, shard_tensor
from .sharded_attention import sharded_attention
from .sharded_decode import context_sharded_paged_decode, shard_pools
from .workloads import kernel_launches, launches_between


def _randn(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def dryrun_rank(device: str = "cuda") -> List[dict]:
    """The dry run's steps on this rank; a record per step."""
    from ..models import ModelConfig, init_params_numpy, params_from_jax
    from ..models.train import make_train_state, make_train_step
    from ..runtime import DecodeEngine

    dev = rank_device(device)
    world = torch.distributed.get_world_size()
    records = []
    before = kernel_launches()

    def done(rec):
        nonlocal before
        now = kernel_launches()
        rec["launches"] = launches_between(before, now)
        before = now
        records.append(rec)

    # --- dp × tp training step --------------------------------------------
    dp = 2 if world % 2 == 0 and world > 1 else 1
    tp = world // dp
    mesh = make_mesh([dp, tp], ("data", "model"))
    cfg = ModelConfig(vocab_size=512, d_model=128, n_layers=2, n_q_heads=max(4, tp),
                      n_kv_heads=max(2, tp), head_dim=32, d_ff=256, dtype=torch.float32,
                      remat=True, attn_dropout=0.1)
    model, opt_state, optimizer = make_train_state(cfg, mesh, seed=0, device=dev)
    step = make_train_step(cfg, optimizer, mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2 * dp, 129), generator=gen, device=dev)
    loss = float(step(model, opt_state, tokens, 0))
    assert loss == loss, "train-step loss is NaN"
    done({"step": "train", "dp": dp, "tp": tp, "loss": loss})
    del model, opt_state

    # --- ring attention over a context axis, forward and backward ---------
    cp_mesh = make_mesh([1, world], ("data", "context"))
    spec = (None, None, "context", None)
    ring = sharded_attention(cp_mesh, "ring", causal=True, model_axis=None, dropout_rate=0.1)
    n = 128 * world
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (shard_tensor(_randn(gen, (1, 2, n, 64), dev), cp_mesh, spec).requires_grad_(True)
               for _ in range(3))
    o = ring(q, k, v, 7)
    assert bool(torch.isfinite(o).all())
    torch.sum(o ** 2).backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    done({"step": "ring", "context": world, "tokens": n})

    # --- zigzag ring against the oracle ----------------------------------
    zz = sharded_attention(cp_mesh, "zigzag", model_axis=None)
    n_zz = 256 * world  # two 128-token chunks a rank
    gen = torch.Generator(device=dev).manual_seed(3)
    qz, kz, vz = (_randn(gen, (1, 2, n_zz, 64), dev) for _ in range(3))
    ql, kl, vl = (shard_tensor(t, cp_mesh, spec, zigzag=True) for t in (qz, kz, vz))
    ql.requires_grad_(True)
    oz = zz(ql, kl, vl)
    full = gather_tensor(oz.detach(), cp_mesh, spec, zigzag=True)
    err = float((full - reference_attention(qz, kz, vz, causal=True, sm_scale=64 ** -0.5))
                .abs().max())
    assert err < 2e-4, err
    torch.sum(oz ** 2).backward()
    assert bool(torch.isfinite(ql.grad).all())
    done({"step": "zigzag", "context": world, "oracle_err": err})

    # --- context-sharded paged decode -------------------------------------
    ctx_mesh = make_mesh([world], ("context",))
    hq, hkv, d, ps, b, ppc = 4, 2, 128, 128, 2, 2
    pool = b * ppc * world
    gen = torch.Generator(device=dev).manual_seed(4)
    kp, vp = (_randn(gen, (hkv, pool, ps, d), dev) for _ in range(2))
    qd = _randn(gen, (b, hq, d), dev)
    lengths = torch.full((b,), ppc * ps, dtype=torch.int32, device=dev)
    table = torch.arange(b * ppc, dtype=torch.int32, device=dev).reshape(b, ppc)
    od = context_sharded_paged_decode(ctx_mesh)(
        qd, shard_pools(kp, ctx_mesh, "context", 1), shard_pools(vp, ctx_mesh, "context", 1),
        lengths, table)
    assert bool(torch.isfinite(od).all())
    done({"step": "context_decode", "context": world})

    # --- tensor-parallel serving ------------------------------------------
    tp_serve = 2 if world % 2 == 0 else 1
    eng_mesh = make_mesh([tp_serve], ("model",), ranks=list(range(tp_serve)))
    if eng_mesh.rank is not None:
        eng_cfg = ModelConfig(vocab_size=256, d_model=128, n_layers=2, n_q_heads=4,
                              n_kv_heads=2, head_dim=32, d_ff=256, dtype=torch.float32)
        eng = DecodeEngine(params_from_jax(init_params_numpy(eng_cfg, 5), eng_cfg, device="cpu"),
                           eng_cfg, num_pages=16, page_size=128, num_slots=2, pages_per_seq=4,
                           kv_dtype=torch.float32, mesh=eng_mesh, device=dev)
        outs = eng.generate([[5, 7, 11], [2, 3]], max_new_tokens=3)
        assert all(len(t) == 3 for t in outs), outs
        assert eng.pools.k[0].shape[0] == eng_cfg.n_kv_heads // tp_serve
        done({"step": "engine", "tp": tp_serve, "tokens": [list(t) for t in outs]})
    else:
        done({"step": "engine", "tp": tp_serve, "tokens": None})
    return records


def dryrun_multichip(world_size: int, *, device: str = "cuda", backend: Optional[str] = None,
                     timeout: float = 600.0) -> List[dict]:
    """The dry run on a group of ``world_size`` ranks (``backend``: "nccl"
    for CUDA, "gloo" for the CPU by default; several ranks on one card need
    "gloo").  Prints rank 0's records, each with every rank's kernel
    launches in that step (``launches_by_rank``), and returns them."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    ranks = launch(dryrun_rank, world_size, device, backend=backend, device=device,
                   timeout=timeout, threads=1 if device.type == "cpu" else None)
    records = ranks[0]
    for i, rec in enumerate(records):
        rec["launches_by_rank"] = [r[i].pop("launches") for r in ranks]
        print(f"[dryrun] {json.dumps(rec)}", flush=True)
    return records


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--backend", default=None)
    args = parser.parse_args(argv)
    dryrun_multichip(args.world, device=args.device, backend=args.backend)
    print("dryrun ok")


if __name__ == "__main__":
    main()
