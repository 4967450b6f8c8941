"""Where an fp32 attention backward over few queries loses accuracy.

    python scripts/torch_bwd_precision.py          # CPU emulation only
    python scripts/torch_bwd_precision.py --card   # also kernel 2 on a GPU

At the AR cond encoder's cross-attention (B 16, 8 heads of D 64, 32
queries against 1024 keys) each key's dK and dV sum over 32 queries, so
the softmax's heavy tail lifts single entries tens of times over the
rms. The emulation computes the backward in float64 with one stage at a
time done in fp32 (the scores' sums, the score storage, the softmax,
g·Vᵀ, the products) and prints max|Δ| / rms of dK and dV against the
float64 backward, the measure and the 1e-5 limit of ``chip_smoke.py``'s
fp32 kernel-2 rows. ``--card`` prints, for seeds 0-2, the same ratios of
dQ, dK and dV for the port's kernel (``attention_packed_bwd``: fp32 over
at most 32 queries runs in fp64, ``csrc/head_bwd.cuh::fp64_backward``)
and for the plain fp32 version (cuBLAS, TF32 off), with the card's name
and power limit. One JSON object a line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

# the repository root, for the port's package when run as a script
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, H, LQ, LK, D = 16, 8, 32, 1024, 64


def _ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.double() - ref).abs().max()
                 / ref.square().mean().sqrt())


def emulate(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    q, k, v, go = (torch.randn(B, H, n, D, generator=g, dtype=torch.float64)
                   .float().double() for n in (LQ, LK, LK, LQ))
    scale = D**-0.5
    f = lambda t: t.float().double()

    def bwd(s, dp, p32=False, prod32=False):
        p = (torch.softmax((s * scale).float(), -1).double() if p32
             else torch.softmax(s * scale, -1))
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        if prod32:
            return ((ds.float().transpose(-1, -2) @ q.float()).double()
                    * scale,
                    (p.float().transpose(-1, -2) @ go.float()).double())
        return (ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ go)

    s, dp = q @ k.transpose(-1, -2), go @ v.transpose(-1, -2)
    s32 = (q.float() @ k.float().transpose(-1, -2)).double()
    dp32 = (go.float() @ v.float().transpose(-1, -2)).double()
    ref = bwd(s, dp)
    cases = {"scores summed in fp32": (s32, dp),
             "scores stored in fp32": (f(s), dp),
             "g·Vᵀ summed in fp32": (s, dp32),
             "softmax in fp32": (s, dp, True),
             "products in fp32": (s, dp, False, True),
             "all fp32": (s32, dp32, True, True)}
    out = {}
    for name, args in cases.items():
        dk, dv = bwd(*args)
        out[name] = [_ratio(dk, ref[0]), _ratio(dv, ref[1])]
    return {"emulation": "dK, dV max|Δ|/rms against float64", "seed": seed,
            **out}


def on_card(seed: int) -> dict:
    from diff_foley_tpu_torch.ops import hopper_attention as ha

    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v, go = (torch.randn((B, n, H * D), generator=gen, device="cuda")
                   for n in (LQ, LK, LK, LQ))
    scale = D**-0.5
    exact = ha.attention_packed_backward_reference(
        *(t.double() for t in (q, k, v, go)), scale, H)
    kern = ha.attention_packed_bwd(q, k, v, go, scale, H)
    plain = ha.attention_packed_backward_reference(q, k, v, go, scale, H)
    names = ("dQ", "dK", "dV")
    return {"card": "kernel 2 and plain fp32, max|Δ|/rms against float64",
            "seed": seed,
            "kernel": {n: _ratio(o, r) for n, o, r in zip(names, kern, exact)},
            "plain": {n: _ratio(o, r) for n, o, r in zip(names, plain,
                                                          exact)}}


def main(argv) -> int:
    for seed in range(3):
        print(json.dumps(emulate(seed)), flush=True)
    if "--card" in argv:
        if not torch.cuda.is_available():
            print("--card needs a GPU", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        for seed in range(3):
            print(json.dumps(on_card(seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
