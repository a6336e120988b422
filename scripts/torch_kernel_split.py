#!/usr/bin/env python3
"""Where one call of K4 (window scatter) and of K1 (fused encoder layer) of the
PyTorch port spends its device time: every device launch the wrapper makes,
by name, under torch.profiler, beside the CUDA-event time of the whole call.

    python3 scripts/torch_kernel_split.py    # needs one CUDA GPU and nvcc

K4 runs at the train shape (grad [4, 1228, 25, 128] onto a [4, 256, 256, 128]
map, f32), K1 at the query step's self shape ([16, 7000, 256], bf16 product
operands): once with loose weights in the [in, out] layout (views of torch
Linear weights, packed at the call) and once with weights packed beforehand,
as the model calls it. Prints the card's name and power limit first. The timer
and the profiler loop are chip_smoke.py's.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import device_rows, phase0, time_ms  # noqa: E402
from onepose_plus_plus_tpu_torch import kernels  # noqa: E402
from onepose_plus_plus_tpu_torch.ops.cuda_encoder import (  # noqa: E402
    fused_encoder_layer,
    fused_encoder_layer_packed,
    pack_encoder_weights,
)
from onepose_plus_plus_tpu_torch.ops.cuda_gather import window_scatter  # noqa: E402


def split(tag: str, fn, reps: int = 10) -> None:
    """Print the whole call's time and its device launches by name (mean per call)."""
    whole = time_ms(fn)
    rows, busy, _ = device_rows(fn, reps=reps)
    print(f"{tag}: whole call {whole:.4f} ms (CUDA events, median of 20); device launches "
          f"sum to {busy / reps:.4f} ms a call (torch.profiler, mean of {reps})")
    for ms, count, key in rows:
        print(f"    {ms / reps:9.4f} ms  x{count / reps:<4.1f} {key[:110]}")


def main() -> int:
    phase0()  # raises without a CUDA GPU; prints the card's name and power limit
    kernels.build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    n, hc, k = 4, 64, 1228
    ids = torch.randint(0, hc * hc, (n, k), generator=gen, device="cuda", dtype=torch.int32)
    ids[:, 1028:] = ids[:, :200]
    ids[:, 1000:1028] = -1
    grad = torch.randn(n, k, 25, 128, generator=gen, device="cuda")
    split("K4 f32 grad[4,1228,25,128] -> map[4,256,256,128]",
          lambda: window_scatter(grad, ids, (hc, hc), 4, 5, (4 * hc, 4 * hc)))

    c = 256
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=gen, device="cuda") * scale  # noqa: E731
    x = rn(16, 7000, c)
    lin = [rn(c, c, scale=c ** -0.5) for _ in range(4)]
    lin += [rn(2 * c, 2 * c, scale=(2 * c) ** -0.5), rn(c, 2 * c, scale=(2 * c) ** -0.5)]
    # torch Linear weights are [out, in]; the model hands the kernels .t() views
    wq, wk, wv, wm, w0, w1 = (w.t() for w in lin)
    ln = [1 + rn(c, scale=0.1), rn(c, scale=0.1), 1 + rn(c, scale=0.1), rn(c, scale=0.1)]
    split("K1 self bf16 x[16,7000,256], loose [in,out] weight views",
          lambda: fused_encoder_layer(x, x, wq, wk, wv, wm, ln[0], ln[1], w0, w1, ln[2], ln[3],
                                      nhead=8, dtype=torch.bfloat16))
    packed = pack_encoder_weights(wq, wk, wv, wm, ln[0], ln[1], w0, w1, ln[2], ln[3],
                                  nhead=8, dtype=torch.bfloat16)
    split("K1 self bf16 x[16,7000,256], weights packed beforehand",
          lambda: fused_encoder_layer_packed(x, x, packed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
