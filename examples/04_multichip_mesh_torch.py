"""Scale out over a process mesh with the PyTorch port: dp x tp sharded
training and ring (sequence-parallel) attention.  The counterpart of
04_multichip_mesh.py.

Every rank runs ``rank_main`` on its shards (SPMD over torch.distributed).
On several cards, one process a card:

    torchrun --nproc-per-node 4 examples/04_multichip_mesh_torch.py --backend nccl

Without torchrun the script starts its own group of ``--world`` ranks
(gloo on one card: NCCL refuses two ranks on one device):

    PYTHONPATH=. python examples/04_multichip_mesh_torch.py --world 4 --backend gloo
    PYTHONPATH=. python examples/04_multichip_mesh_torch.py --cpu-mesh   # 4 gloo ranks, CPU
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_dlrs_tpu_torch.models import ModelConfig, make_train_state, make_train_step
from flash_attention_dlrs_tpu_torch.ops import reference_attention
from flash_attention_dlrs_tpu_torch.parallel import initialize_distributed, make_mesh, ring_attention
from flash_attention_dlrs_tpu_torch.parallel.launch import launch
from flash_attention_dlrs_tpu_torch.parallel.mesh import gather_tensor, rank_device, shard_tensor


def rank_main(device):
    dev = rank_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a: None)
    say(f"{world} ranks ({dev.type}, {dist.get_backend()})")

    # --- dp x tp training: params sharded over 'model', batch over 'data'.
    # The model axis must divide the head counts (4 q / 2 kv here): tp 2.
    tp = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    cfg = ModelConfig.tiny(dtype=torch.float32, remat=False)
    model, opt_state, optimizer = make_train_state(cfg, mesh, seed=0, device=dev,
                                                   learning_rate=1e-3)
    step = make_train_step(cfg, optimizer, mesh)
    data = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (4, 129))).to(dev)
    for i in range(2):
        say(f"sharded train step {i}: loss {float(step(model, opt_state, data)):.4f}")

    # --- ring attention: K/V blocks rotate around a context axis, so the
    # sequence shards across every rank; the lse merge is exact, and the
    # backward rotates the dK/dV accumulators the same way.
    ring_mesh = make_mesh((world,), ("ctx",))
    b, h, n, d = 1, 4, 1024, 64
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=dev) for _ in range(3))
    spec = (None, None, "ctx", None)
    o = ring_attention(*(shard_tensor(t, ring_mesh, spec) for t in (q, k, v)),
                       mesh=ring_mesh, axis_name="ctx", causal=False, sm_scale=d ** -0.5)
    o = gather_tensor(o, ring_mesh, spec)
    ref = reference_attention(q, k, v, sm_scale=d ** -0.5)
    say("ring attention max err vs dense:", float((o - ref).abs().max()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu-mesh", action="store_true", help="4 gloo ranks on the CPU")
    parser.add_argument("--world", type=int, default=4)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    device = "cpu" if args.cpu_mesh else args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun
        initialize_distributed(args.backend, device=device)
        rank_main(device)
        dist.destroy_process_group()
        return
    backend = "gloo" if args.cpu_mesh else (args.backend or "nccl")
    launch(rank_main, 4 if args.cpu_mesh else args.world, device, backend=backend,
           device=device, timeout=600, threads=1 if device == "cpu" else None)


if __name__ == "__main__":
    main()
