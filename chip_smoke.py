"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # build, kernel, pipeline, agreement
    python3 chip_smoke.py --profile  # also torch.profiler over two steps

1. Build the CUDA kernels from ``diff_foley_tpu_torch/csrc`` (in parallel).
2. Kernel phase: each kernel against its plain PyTorch version at every
   shape of the main path, in bf16 and once in fp32, with times beside the
   plain version's, PyTorch's SDPA (a yardstick the port never calls) and
   the card's bound. A planted fault per kernel must fail the same check.
3. Pipeline phase: ``DiffFoleyPipeline.generate`` at full width (the 860M
   LDM UNet and the alignment classifier in bf16, the SD VAE in bf16,
   seeded random weights), 2 windows × 2 samples, 25 DPM-Solver++ steps,
   CFG 4.5, classifier guidance 50, 32 Griffin-Lim iterations, int16 wav.
   Launch counts are reset just before and read just after, and must equal
   what the model structure predicts.
4. Agreement: a tiny pipeline in float32 on the GPU (kernels) against the
   same pipeline on the CPU (plain versions), shared x_T and phase.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before it. With no GPU it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from diff_foley_tpu_torch.diffusion.latent_diffusion import (LatentDiffusion,
                                                              LDMConfig)
from diff_foley_tpu_torch.models.attention import SpatialTransformer
from diff_foley_tpu_torch.models.unet import (CLASSIFIER_BACKBONE, LDM_UNET,
                                              ClassifierBackbone, UNetConfig)
from diff_foley_tpu_torch.models.vae import VAEConfig
from diff_foley_tpu_torch.ops import cuda_build
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.pipeline import (LATENT_HW, WINDOW_FEATS,
                                           WINDOW_SAMPLES, DiffFoleyPipeline,
                                           GenerationConfig)
from diff_foley_tpu_torch.utils.init import randomize_

PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
WINDOWS, SAMPLES, STEPS = 2, 2, 25
# Agreement with the plain version, per output tensor, against the size of
# the plain output: max|Δ| ≤ MAX_TOL·rms(plain) and rms(Δ) ≤ RMS_TOL·rms(plain).
# The max catches a local fault (a tile, an edge), the rms a small fault
# spread over every element. Each limit is a few times the largest ratio
# the kernels reach at the path's shapes; a planted fault per kernel must
# exceed them (see FAULTS).
MAX_TOL = {("fwd", torch.bfloat16): 0.06, ("fwd", torch.float32): 5e-6,
           ("bwd", torch.bfloat16): 0.25, ("bwd", torch.float32): 1e-5}
RMS_TOL = {("fwd", torch.bfloat16): 4e-4, ("fwd", torch.float32): 3e-7,
           ("bwd", torch.bfloat16): 0.015, ("bwd", torch.float32): 5e-7}
KERNELS = {
    "attn_packed_fwd": ("diff_foley_tpu_torch/csrc/attention_fwd.cu",
                        "diff_foley_tpu/ops/pallas_attention.py:294"),
    "attn_packed_bwd": ("diff_foley_tpu_torch/csrc/attention_bwd.cu",
                        "diff_foley_tpu/ops/pallas_attention.py:400"),
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def path_shapes(n: int, lk: int):
    """(tag, batch, Lq, Lk, H·D, heads, calls per sampler step) of every
    attention on the path: self and cross in each SpatialTransformer."""
    out = []
    for name, cfg, batch in (("unet", LDM_UNET, 2 * n),
                             ("clf", CLASSIFIER_BACKBONE, n)):
        # transformers per attention level: down blocks, and the UNet's up
        blocks = cfg.num_res_blocks + (
            cfg.num_res_blocks + 1 if name == "unet" else 0)
        sites = [(str(lv), lv, blocks) for lv in range(len(cfg.channel_mult))
                 if 2**lv in cfg.attention_resolutions]
        sites.append(("mid", len(cfg.channel_mult) - 1, 1))
        for tag, lv, n_blocks in sites:
            L = (LATENT_HW[0] >> lv) * (LATENT_HW[1] >> lv)
            hd = cfg.channel_mult[lv] * cfg.model_channels
            calls = n_blocks * cfg.transformer_depth
            out.append((f"{name}-{tag}-self", batch, L, L, hd, cfg.num_heads,
                        calls))
            out.append((f"{name}-{tag}-cross", batch, L, lk, hd,
                        cfg.num_heads, calls))
    return out


def bound_ms(kind: str, b, lq, lk, hd, itemsize: int, peak: float):
    prods = 2 if kind == "fwd" else 5
    flops = prods * 2 * b * lq * lk * hd
    tensors = (2 * b * lq * hd + 2 * b * lk * hd if kind == "fwd"
               else 3 * b * lq * hd + 4 * b * lk * hd)
    t_ops = flops / peak * 1e3
    t_bytes = tensors * itemsize / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def agreement(outs, refs, kind: str, dtype):
    """(ok, max|Δ|, max|Δ|/rms(plain), rms(Δ)/rms(plain)), the ratios the
    worst over the output tensors."""
    ok, err, max_r, rms_r = True, 0.0, 0.0, 0.0
    for a, r in zip(outs, refs):
        a, r = a.float(), r.float()
        delta = (a - r).abs()
        scale = float(r.square().mean().sqrt())
        e = float(delta.max())
        mr, rr = e / scale, float(delta.square().mean().sqrt()) / scale
        ok &= (bool(torch.isfinite(a).all()) and mr <= MAX_TOL[(kind, dtype)]
               and rr <= RMS_TOL[(kind, dtype)])
        err, max_r, rms_r = max(err, e), max(max_r, mr), max(rms_r, rr)
    return ok, err, max_r, rms_r


def fault_fwd_neighbour_head(q, k, v, scale, heads):
    """Planted fault: each head reads the V columns of the head before it,
    as a packed kernel with a wrong column offset would."""
    d = q.shape[-1] // heads
    return (ha.attention_packed_reference(q, k, v.roll(d, dims=-1), scale,
                                          heads),)


def fault_bwd_no_delta(q, k, v, g, scale, heads):
    """Planted fault: the plain backward with dS = P∘(g·Vᵀ), the row term
    δ = Σ(g·Vᵀ∘P) left out."""
    qh, kh, vh, gh = (ha.split_heads(t, heads) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qh.float(),
                                   kh.float()) * scale, dim=-1)
    gv = torch.einsum("bhqk,bhqd->bhkd", p.to(g.dtype), gh)
    ds = (p * torch.einsum("bhqd,bhkd->bhqk", gh, vh).float()).to(q.dtype)
    gq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    gk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    return tuple(ha.merge_heads(t) for t in (gq, gk, gv))


FAULTS = {"fwd": fault_fwd_neighbour_head, "bwd": fault_bwd_no_delta}


def check_kernel(kind: str, tag, b, lq, lk, hd, heads, dtype, gen):
    d = hd // heads
    scale = d**-0.5
    q = torch.randn((b, lq, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, lk, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, lk, hd), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, lq, hd), generator=gen, device="cuda").to(dtype)
    qh, kh, vh = (ha.split_heads(t, heads) for t in (q, k, v))
    if kind == "fwd":
        kern = lambda: ha.attention_packed_fwd(q, k, v, scale, heads)
        plain = lambda: ha.attention_packed_reference(q, k, v, scale, heads)
        lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        outs, refs = (kern(),), (plain(),)
        faulty = FAULTS[kind](q, k, v, scale, heads)
    else:
        kern = lambda: ha.attention_packed_bwd(q, k, v, g, scale, heads)
        plain = lambda: ha.attention_packed_backward_reference(
            q, k, v, g, scale, heads)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
        o = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
        gh = ha.split_heads(g, heads)
        lib = lambda: torch.autograd.grad(o, (ql, kl, vl), gh,
                                          retain_graph=True)
        outs, refs = kern(), plain()
        faulty = FAULTS[kind](q, k, v, g, scale, heads)
    torch.cuda.synchronize()
    ok, err, max_r, rms_r = agreement(outs, refs, kind, dtype)
    fault_ok, _, fault_max_r, fault_rms_r = agreement(faulty, refs, kind,
                                                      dtype)
    ms = time_ms(kern)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lib)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    bms, by = bound_ms(kind, b, lq, lk, hd, q.element_size(), peak)
    return {"shape": tag, "dtype": str(dtype).split(".")[-1],
            "B": b, "Lq": lq, "Lk": lk, "HD": hd, "D": d,
            "max_abs_err": err, "max_ratio": max_r, "rms_ratio": rms_r,
            "tol": [MAX_TOL[(kind, dtype)], RMS_TOL[(kind, dtype)]],
            "ok": ok, "fault": FAULTS[kind].__name__,
            "fault_ratios": [fault_max_r, fault_rms_r],
            "fault_caught": not fault_ok, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
            "bound_by": by}


def kernel_phase(n: int):
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    shapes = path_shapes(n, WINDOW_FEATS)
    for tag, b, lq, lk, hd, heads, calls in shapes:
        r = check_kernel("fwd", tag, b, lq, lk, hd, heads, torch.bfloat16, gen)
        r["calls_per_step"] = calls
        rows.append(("attn_packed_fwd", r))
        if tag.startswith("clf"):
            r = check_kernel("bwd", tag, b, lq, lk, hd, heads,
                             torch.bfloat16, gen)
            r["calls_per_step"] = calls
            rows.append(("attn_packed_bwd", r))
    # once in fp32: the UNet's level-0 cross shape and the classifier's
    # level-1 self shape
    rows.append(("attn_packed_fwd", check_kernel(
        "fwd", "unet-0-cross", 2 * n, 1024, WINDOW_FEATS, 320, 8,
        torch.float32, gen)))
    rows.append(("attn_packed_bwd", check_kernel(
        "bwd", "clf-1-self", n, 256, 256, 256, 8, torch.float32, gen)))
    # reset after the comparisons: they are not the main path's launches
    ha.reset_launch_counts()
    log("kernels " + json.dumps([dict(kernel=k, **r) for k, r in rows]))
    bad = [(k, r["shape"], r["dtype"], r["max_ratio"], r["rms_ratio"])
           for k, r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    missed = [(k, r["shape"], r["dtype"], r["fault"]) for k, r in rows
              if not r["fault_caught"]]
    if missed:
        raise AssertionError(f"the comparison passes a planted fault: {missed}")
    return rows


def summarize(rows, launches):
    """One entry per kernel: its bf16 path shapes summed over one sampler
    step's calls (ms, plain_ms, library_ms, bound_ms), its largest error,
    and its launches in the main-path run."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        rs = [r for k, r in rows if k == name and "calls_per_step" in r]
        tot = lambda key: sum(r[key] * r["calls_per_step"] for r in rs)
        t_ops = sum(r["bound_ms"] * r["calls_per_step"] for r in rs
                    if r["bound_by"] == "operations")
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for k, r in rows if k == name),
            "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "operations" if t_ops >= tot("bound_ms") / 2
            else "bytes",
            "library_ms": tot("library_ms"),
        })
    return out


def build_flagship(seed: int = 0):
    ldm = LatentDiffusion(LDMConfig(
        unet=dataclasses.replace(LDM_UNET, dtype="bfloat16")))
    randomize_(ldm, seed)
    ldm.unet.to(torch.bfloat16)   # the cond encoder stays float32
    clf = randomize_(ClassifierBackbone(
        dataclasses.replace(CLASSIFIER_BACKBONE, dtype="bfloat16")), seed + 1)
    return DiffFoleyPipeline(ldm, clf.to(torch.bfloat16),
                             vae_dtype="bfloat16", device="cuda")


def predicted_launches(pipe, steps: int):
    count = lambda m: sum(2 * x.depth for x in m.modules()
                          if isinstance(x, SpatialTransformer))
    unet, clf = count(pipe.ldm.unet), count(pipe.classifier)
    return {"attn_packed_fwd": steps * (unet + clf),
            "attn_packed_bwd": steps * clf}


def pipeline_phase(profile: bool):
    t0 = time.perf_counter()
    pipe = build_flagship()
    torch.cuda.synchronize()
    log(f"pipeline build+random weights {time.perf_counter() - t0:.3f} s")
    feats = np.random.default_rng(0).standard_normal(
        (WINDOWS * WINDOW_FEATS, 512)).astype(np.float32)
    gen = GenerationConfig(steps=STEPS, sample_num=SAMPLES, wav_dtype="int16")

    ha.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe.generate(feats, seed=0, gen=gen)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(ha.LAUNCHES)
    expect = predicted_launches(pipe, STEPS)
    wav, spec = out["wav"], out["spec"]
    log(f"pipeline generate {cold_s:.3f} s (first call) wav {wav.shape} "
        f"{wav.dtype} spec {spec.shape} peak_mem_GiB "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")
    log(f"launches {json.dumps(launches)} predicted {json.dumps(expect)}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    if wav.shape != (SAMPLES, WINDOWS * WINDOW_SAMPLES) or wav.dtype != np.int16:
        raise AssertionError(f"wav {wav.shape} {wav.dtype}")
    if spec.shape != (SAMPLES, 128, WINDOWS * 512) or not np.isfinite(spec).all():
        raise AssertionError(f"spec {spec.shape} finite={np.isfinite(spec).all()}")
    if not (spec.min() >= 0.0 and spec.max() <= 1.0):
        raise AssertionError("spec leaves [0, 1]")
    log(f"spec finite {bool(np.isfinite(spec).all())} in [0, 1] "
        f"mean {float(spec.mean()):.6f}; wav int16 |max| "
        f"{int(np.abs(wav.astype(np.int32)).max())}")

    # a second, warm call split into its stages
    stages = {}
    feats_w = torch.as_tensor(feats.reshape(WINDOWS, WINDOW_FEATS, 512),
                              device="cuda")
    g = torch.Generator("cuda").manual_seed(1)

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t
        return r

    with torch.no_grad():
        cond = feats_w.repeat_interleave(SAMPLES, dim=0)
        z = stage("sampler_s", lambda: pipe.ldm.sample(
            cond, steps=STEPS, cfg_scale=gen.cfg_scale,
            classifier=pipe.classifier,
            classifier_scale=gen.classifier_scale, generator=g))
        specs = stage("vae_decode_s", lambda: torch.clamp(
            pipe.ldm.decode_first_stage(z.to(torch.bfloat16))[..., 0].float(),
            0.0, 1.0))
        from diff_foley_tpu_torch.audio.transforms import mel_to_wav
        stage("griffin_lim_s", lambda: mel_to_wav(
            specs, n_iter=gen.gl_iters, length=WINDOW_SAMPLES, generator=g))
    stages["total_s"] = sum(stages.values())
    log("pipeline warm stages " + json.dumps(stages))
    if profile:
        profile_steps(pipe, cond, gen)
    return launches, {"first_call_s": cold_s, **stages}


def profile_steps(pipe, cond, gen, steps: int = 2):
    """torch.profiler over a warm sampler run of ``steps`` steps: device
    busy time per step (the union of the kernels' intervals), the idle
    share of the wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = lambda: pipe.ldm.sample(
        cond, steps=steps, cfg_scale=gen.cfg_scale,
        classifier=pipe.classifier, classifier_scale=gen.classifier_scale,
        generator=torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for k in kernels:
        t = by_name.setdefault(k.name, [0.0, 0])
        t[0] += k.time_range.elapsed_us()
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    log("profile " + json.dumps({
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernels_per_step": len(kernels) / steps,
        "top": [{"name": n[:90], "ms_per_step": t / 1e3 / steps,
                 "calls_per_step": c / steps} for n, (t, c) in top]}))


def agreement_phase():
    """Tiny float32 pipeline: GPU (kernels) against CPU (plain versions).
    Head dims 40 and 80 in the UNet, 32 in the classifier: the kernels
    take the path's head dims only."""
    ucfg = UNetConfig(model_channels=160, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(1, 2),
                      num_heads=4, context_dim=64)
    ccfg = UNetConfig(out_channels=1, model_channels=32, num_res_blocks=1,
                      channel_mult=(1, 2), attention_resolutions=(2,),
                      num_heads=2, context_dim=512)
    ldm = randomize_(LatentDiffusion(LDMConfig(
        unet=ucfg, vae=VAEConfig(ch=32, ch_mult=(1, 1, 1, 1),
                                 num_res_blocks=1), cond_embed_dim=64)), 3)
    clf = randomize_(ClassifierBackbone(ccfg), 4)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((WINDOW_FEATS, 512)).astype(np.float32)
    x_T = torch.as_tensor(rng.standard_normal((2, *LATENT_HW, 4)),
                          dtype=torch.float32)
    phase = torch.as_tensor(rng.uniform(size=(2, 513, 512)),
                            dtype=torch.float32)
    gen = GenerationConfig(steps=3, sample_num=2, gl_iters=4)
    outs = {}
    for device in ("cpu", "cuda"):
        pipe = DiffFoleyPipeline(copy.deepcopy(ldm), copy.deepcopy(clf),
                                 device=device)
        outs[device] = pipe.generate(feats, gen=gen, x_T=x_T.to(device),
                                     gl_phase=phase.to(device))
    d_spec = float(np.abs(outs["cpu"]["spec"] - outs["cuda"]["spec"]).max())
    d_wav = float(np.abs(outs["cpu"]["wav"] - outs["cuda"]["wav"]).max())
    wav_scale = float(np.abs(outs["cpu"]["wav"]).max())
    log(f"agreement tiny fp32 gpu-vs-cpu spec max|Δ| {d_spec:.3e} (tol 1e-3) "
        f"wav max|Δ| {d_wav:.3e} of |wav| {wav_scale:.3e} (tol 1e-2·|wav|)")
    if not d_spec <= 1e-3 or not d_wav <= 1e-2 * max(wav_scale, 1e-6):
        raise AssertionError("GPU pipeline disagrees with the CPU pipeline")


def main(argv):
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = cuda_build.build()
    log(f"build {time.perf_counter() - t0:.3f} s "
        + json.dumps({k: round(v["seconds"], 3) for k, v in report.items()}))
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    rows = kernel_phase(WINDOWS * SAMPLES)
    launches, times = pipeline_phase("--profile" in argv)
    log("pipeline times " + json.dumps(times))
    agreement_phase()
    log(json.dumps({"kernels": summarize(rows, launches)}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
