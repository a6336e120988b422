#!/usr/bin/env python3
"""How far K1's f32 layer lies from the same layer in float64, by route.

    python3 scripts/torch_k1_f32_drift.py    # needs one CUDA GPU and nvcc

For random layers (weights and inputs from a seed, as tests/test_torch_cuda.py
makes them) at (C, heads) = (256, 8), (512, 8), (1024, 8) and (128, 16), batch
4, prints the mean |y - y64| of: the kernel the router picks for f32 operands
(``tf32x3`` at (256, 8), ``tcw_tf32`` elsewhere), the plain version in f32 on
cuBLAS with TF32 off, the plain version with every two-operand product split
into three TF32 products of hi / lo halves as the kernels split them
(``kernels.tf32x3_matmul``, on cuBLAS, so f32 sums), and the plain version
with PyTorch's single TF32 products (``allow_tf32``); y64 is the plain version
in float64. The kernel's mean signed difference (its bias) too. One JSON line
at the end.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from onepose_plus_plus_tpu_torch.kernels import tf32x3_matmul  # noqa: E402
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (  # noqa: E402
    encoder_layer_plain,
    fused_encoder_layer,
    k1_instance,
)

CASES = ((256, 8, 1000, 1500, False), (512, 8, 1000, 1500, False), (1024, 8, 777, None, True),
         (128, 16, 777, None, False))  # (C, heads, L, S or None for a self layer, masks)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    rec = {}
    for c, nhead, l, s, masks in CASES:
        rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
        x = rn(4, l, c)
        src = x if s is None else rn(4, s, c)
        w = [rn(c, c, scale=c ** -0.5) for _ in range(4)] + [1 + rn(c, scale=0.1), rn(c, scale=0.1),
                                                             rn(2 * c, 2 * c, scale=(2 * c) ** -0.5),
                                                             rn(2 * c, c, scale=(2 * c) ** -0.5),
                                                             1 + rn(c, scale=0.1), rn(c, scale=0.1)]
        xm = (torch.rand(4, l, generator=gen, device="cuda") > 0.3).float() if masks else None
        sm = (torch.rand(4, src.shape[1], generator=gen, device="cuda") > 0.3).float() if masks else None
        exact = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float64)

        def dist(y):
            return (y.double() - exact).abs().mean().item()

        got = fused_encoder_layer(x, src, *w, xm, sm, nhead=nhead, dtype=torch.float32)
        plain = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead)
        split = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead, matmul=tf32x3_matmul)
        torch.backends.cuda.matmul.allow_tf32 = True
        single = encoder_layer_plain(x, src, *w, xm, sm, nhead=nhead)
        torch.backends.cuda.matmul.allow_tf32 = False
        r = {"instance": k1_instance(c, nhead, torch.float32), "kernel": dist(got),
             "kernel_bias": (got.double() - exact).mean().item(), "plain_f32": dist(plain),
             "plain_split_tf32": dist(split), "plain_single_tf32": dist(single)}
        rec[f"c{c}_h{nhead}"] = r
        print(f"C = {c}, {nhead} heads ({r['instance']}): mean |y - y64| kernel {r['kernel']:.3e} (bias "
              f"{r['kernel_bias']:.2e}), plain f32 {r['plain_f32']:.3e}, plain split TF32 {r['plain_split_tf32']:.3e}, "
              f"plain single TF32 {r['plain_single_tf32']:.3e}", flush=True)
    print(json.dumps({"gpu": smi, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
