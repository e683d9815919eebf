"""Quickstart of the PyTorch port: MSDeformAttn + the DEFA optimization
stack (port of examples/quickstart.py).

Builds the paper's operator, runs the exact oracle and the DEFA-optimized
path (PAP top-k + FWP compaction + range narrowing + INT12), holds the
fused CUDA kernel K1 (``cuda_fused``) against the plain gather path, and
prints the measured sparsity. On the CPU the kernel wrapper runs its
plain PyTorch version.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.bridge import resolve_device
from repro_torch.core.msdeform_attn import (
    MSDeformAttnConfig, init_msdeform_attn, msdeform_attn_apply,
    msdeform_attn_ref)

LEVELS = ((32, 40), (16, 20), (8, 10), (4, 5))
N_IN = sum(h * w for h, w in LEVELS)
B, NQ, D = 2, 256, 128


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    gen = torch.Generator().manual_seed(0)
    cfg = MSDeformAttnConfig(d_model=D, n_heads=8)
    params = init_msdeform_attn(cfg, gen, device=dev)
    query = torch.randn((B, NQ, D), generator=gen).to(dev)
    fmaps = torch.randn((B, N_IN, D), generator=gen).to(dev)
    refs = torch.rand((B, NQ, 2), generator=gen).to(dev)

    with torch.no_grad():
        # 1. exact oracle ----------------------------------------------------
        out_exact = msdeform_attn_ref(params, cfg, query, refs, fmaps, LEVELS)
        print(f"exact MSDeformAttn: out {tuple(out_exact.shape)}")

        # 2. DEFA stack (plain gather path) ----------------------------------
        defa = MSDeformAttnConfig(
            d_model=D, n_heads=8,
            pap_mode="topk", pap_keep=6,               # keep 6 of 16 points
            fwp_mode="compact", fwp_k=1.0, fwp_capacity=0.6,
            range_narrow=(16.0, 12.0, 8.0, 4.0),
            act_bits=12, weight_bits=12, backend="torch_gather")
        # block k produces the fmap mask for block k+1: chain two calls
        _, aux = msdeform_attn_apply(params, defa, query, refs, fmaps, LEVELS,
                                     collect_stats=True)
        out_defa, aux2 = msdeform_attn_apply(params, defa, query, refs, fmaps,
                                             LEVELS, fwp_state=aux["fwp_state"],
                                             collect_stats=True)
        err = float(torch.mean(torch.abs(out_defa - out_exact)))
        print(f"DEFA (PAP 6/16 + FWP 60% + RN + INT12): mean |delta| = {err:.4f}")
        print(f"  points kept: {float(aux2['pap_keep_frac']):.2%}  "
              f"pixels kept: {float(aux2['fwp_keep_frac']):.2%}")

        # 3. fused CUDA kernel K1 --------------------------------------------
        fused = dataclasses.replace(defa, backend="cuda_fused")
        out_kernel, _ = msdeform_attn_apply(params, fused, query, refs, fmaps,
                                            LEVELS, fwp_state=aux["fwp_state"])
    torch.testing.assert_close(out_kernel, out_defa, rtol=1e-4, atol=1e-4)
    print(f"fused MSGS+aggregation kernel (cuda_fused, {dev.type}) == gather "
          "path  [OK]")


if __name__ == "__main__":
    main()
