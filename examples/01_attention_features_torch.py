"""Tour of the PyTorch port's attention op: masking features, GQA, grads,
the nn adapter.  The counterpart of 01_attention_features.py.

Runs on the CUDA card by default (the port's kernels, built from csrc/ on
first use); ``--device cpu`` runs the kernels' plain PyTorch versions.

    PYTHONPATH=. python examples/01_attention_features_torch.py [--device cpu]
"""

import argparse

import torch

import flash_attention_dlrs_tpu_torch as fa


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = torch.device(parser.parse_args().device)

    b, hq, hkv, n, d = 2, 8, 2, 512, 64  # GQA: 4 query heads per KV head
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, device=device)
               for h in (hq, hkv, hkv))

    # Plain causal (sm_scale defaults to 1/sqrt(d)).
    o = fa.flash_attention(q, k, v, causal=True)
    print("causal GQA:", tuple(o.shape), o.dtype)

    # Sliding window: each token sees the last 128 tokens (incl. itself).
    o_w = fa.flash_attention(q, k, v, causal=True, window=128)
    print("window=128 delta vs full:", float((o - o_w).abs().max()))

    # Logit softcap (tanh capping, as in Gemma-2-style models).
    o_c = fa.flash_attention(q, k, v, causal=True, logit_softcap=30.0)
    print("softcap=30 delta vs none:", float((o - o_c).abs().max()))

    # Packed sequences: two documents per row, no attention between them;
    # the kernels mask by segment id (no N x N mask is made).
    seg = (torch.arange(n, device=device)[None, :] >= n // 2).to(torch.int32).expand(b, n)
    o_s = fa.flash_attention(q, k, v, causal=True, segment_ids=seg.contiguous())
    print("packed-segments delta:", float((o - o_s).abs().max()))

    # Differentiable: the backward kernels (deterministic two-sweep).
    qg = q.clone().requires_grad_(True)
    fa.flash_attention(qg, k, v, causal=True).sum().backward()
    print("dQ:", tuple(qg.grad.shape), "finite:", bool(torch.isfinite(qg.grad).all()))

    # Oracle check (the plain reference the tests use).
    ref = fa.reference_attention(q, k, v, causal=True, sm_scale=d ** -0.5)
    print("max |O - oracle|:", float((o - ref).abs().max()))

    # jax.nn users: change one import.  BTNH layout, same semantics.
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    o_nn = fa.nn.dot_product_attention(qt, kt, vt, is_causal=True)
    print("nn adapter matches:", float((o_nn.transpose(1, 2) - o).abs().max()))


if __name__ == "__main__":
    main()
