"""Attention kernel rows of ``chip_smoke.py`` in two or more checkouts of
the port, on one GPU, for comparing their device times.

    python scripts/torch_kernel_ab.py DIR [DIR ...]

Each DIR is the root of a checkout (its ``chip_smoke.py`` and
``diff_foley_tpu_torch/``; a directory may be named more than once, as in
parent, change, change, parent). Each runs, in the order given, in a
process of its own, which builds that checkout's kernels into its own
``build/kernels`` and runs the rows below through that checkout's
``chip_smoke.py`` check functions: agreement with the plain version,
planted faults, device time with the L2 flushed. Each row's operands come
from a generator seeded by the row, so every checkout sees the same
inputs. Rows at a head dim a checkout does not take are skipped there;
``AB_ROWS`` (comma-separated tag prefixes) keeps only the rows it names.

The rows are the fp32 attention rows of the classifier trainer (c) and
align-acc (a), the VAE trainer's mid attention (t), the spec decoder's
(r), the 1-D audio UNet's (u), the diffusion prior's (p) and the
attention pool's (n), and one bf16 control row whose code no checkout
changes. Prints one JSON line per checkout and row and writes all of them,
with each checkout's card (name and power limit) and ptxas register and
spill lines, to ``$AB_OUT`` (default ``build/kernel_ab.json``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

KEYS = ("device_ms", "kernel_ms", "plain_ms", "library_device_ms",
        "max_ratio", "rms_ratio", "ok", "fault_caught", "float64_ratios",
        "plain_float64_ratios")


def rows_of(cs) -> list:
    """(kernel, tag, check function, its arguments but the generator)."""
    ha = cs.ha
    fp32, bf16 = cs.FP32, cs.BF16
    out = []
    for tag, b, lq, lk, hd, heads, _ in cs.attention_sites(
            "c-clf", cs.CLASSIFIER_BACKBONE, cs.C_BATCH, cs.S2_TOKENS, False):
        for kind, name in (("fwd", "attn_packed_fwd"),
                           ("bwd", "attn_packed_bwd")):
            out.append((name, tag, cs.check_packed,
                        (kind, tag, b, lq, lk, hd, heads, fp32)))
    for tag, b, lq, lk, hd, heads, _ in cs.attention_sites(
            "a-clf", cs.CLASSIFIER_BACKBONE, cs.AA_BATCH, cs.AA_TOKENS,
            False):
        out.append(("attn_packed_fwd", tag, cs.check_packed,
                    ("fwd", tag, b, lq, lk, hd, heads, fp32)))
    d = cs.SD_VAE.ch * cs.SD_VAE.ch_mult[-1]
    l = cs.LATENT_HW[0] * cs.LATENT_HW[1]
    _, t_dec, d_dec = cs.decode_sites()
    for tag, b, n, dd in (("train-mid", cs.TRAIN_BATCH, l, d),
                          ("r-dec-mid", cs.DEC_BATCH, t_dec, d_dec)):
        out.append(("attn_fwd", tag, cs.check_head, (tag, b, n, n, dd, fp32)))
        out.append(("attn_bwd", tag, cs.check_head_bwd,
                    (tag, b, n, n, dd, fp32)))
    for tag, b, n, hd in (("u-d48-self", 4, 2048, 384),
                          ("u-d96-self", 4, 1024, 768)):
        if hd // 8 in ha._HEAD_DIMS:
            for kind, name in (("fwd", "attn_packed_fwd"),
                               ("bwd", "attn_packed_bwd")):
                out.append((name, tag, cs.check_packed,
                            (kind, tag, b, n, n, hd, 8, fp32)))
    if hasattr(cs, "check_head_rows"):
        for tag, b, lq, lk, dd in (("p-loss", 64, 16, 16, 64),
                                   ("n-pool", 16, 1, 65, 32)):
            if dd in ha._HEAD_DIMS_PER_HEAD:
                for kind, name in (("head", "attn_fwd"),
                                   ("head_bwd", "attn_bwd")):
                    out.append((name, tag, cs.check_head_rows,
                                (kind, tag, b, 8, lq, lk, dd, fp32)))
    out.append(("attn_packed_fwd", "ctl-bf16", cs.check_packed,
                ("fwd", "ctl-bf16", 4, 256, 256, 256, 8, bf16)))
    return out


def one(tree: str) -> list:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from diff_foley_tpu_torch.ops import cuda_build

    if not Path(cs.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"chip_smoke came from {cs.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = cuda_build.build(("attention_fwd", "attention_bwd",
                               "attention_head_fwd", "attention_head_bwd"))
    regs = {name: [ln.strip() for ln in r["ptxas"].splitlines()
                   if any(w in ln for w in ("registers", "Compiling", "spill"))]
            for name, r in report.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    only = os.environ.get("AB_ROWS")   # comma-separated tag prefixes
    rows = []
    for i, (kernel, tag, fn, args) in enumerate(rows_of(cs)):
        if only and not any(tag.startswith(p) for p in only.split(",")):
            continue
        gen = torch.Generator("cuda").manual_seed(1000 + i)
        r = fn(*args, gen)
        row = {"tree": tree, "kernel": kernel, "shape": tag,
               "dtype": r["dtype"], **{k: r[k] for k in KEYS if k in r}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    return [{"tree": tree, "card": card, "ptxas": regs}] + rows


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print("AB " + json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        p = subprocess.run([sys.executable, __file__, "--one", tree],
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode:
            print(p.stdout[-4000:])
            return p.returncode
        line = [x for x in p.stdout.splitlines() if x.startswith("AB ")][-1]
        runs.append(json.loads(line[3:]))
        for row in runs[-1][1:]:
            print(json.dumps(row), flush=True)
    out = Path(os.environ.get("AB_OUT", "build/kernel_ab.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(runs, f, indent=1)
    # one line per row: the device ms of each run in order
    table = {}
    for run in runs:
        for row in run[1:]:
            table.setdefault((row["kernel"], row["shape"], row["dtype"]),
                             []).append(row["device_ms"])
    for key, ms in table.items():
        print(" ".join(key), " ".join(f"{x:.4g}" for x in ms))
    print(runs[0][0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
