"""Model profiler: parameters and FLOPs per model family
(``diff_foley_tpu/cli/profile.py``).

Each family's forward is counted by ``utils.profiling.cost_analysis`` (the
attention and GroupNorm kernels by formula) in fp32 at the JAX profiler's
shapes: the UNet over (b, 16, 64, 4) latents and a 40-token 768-d context,
the VAE encoding a (b, 128, 512, 3) mel image and decoding a (b, 16, 64, 4)
latent, the classifier with a 40-token 512-d context, CAVP over (b, 16,
224, 224, 3) video and a (b, 128, 256) spec. The weights are the modules'
construction values (zero kernels), built on the device; ``--time``
also times ``TIME_ITERS`` calls after a warm one.

Usage:
  python -m diff_foley_tpu_torch.cli.profile [--family unet|vae|classifier|cavp|all]
      [--batch 1] [--time] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from ..models.cavp import CAVPConfig, CAVPModel
from ..models.unet import (CLASSIFIER_BACKBONE, LDM_UNET, ClassifierBackbone,
                           UNetModel)
from ..models.vae import SD_VAE, AutoencoderKL
from ..pipeline import resolve_device
from ..utils.profiling import cost_analysis, count_params, timed_call

# each family's config, read at the call: a test swaps in a tiny one
UNET_CFG = LDM_UNET
VAE_CFG = SD_VAE
CLASSIFIER_CFG = CLASSIFIER_BACKBONE
CAVP_CFG = CAVPConfig()
# {input name: its shape after the batch}
SHAPES = {"latent": (16, 64, 4), "context": (40, 768), "spec": (128, 512, 3),
          "clf_context": (40, 512), "video": (16, 224, 224, 3),
          "cavp_spec": (128, 256)}
TIME_ITERS = 5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--family", default="all",
                   choices=["unet", "vae", "classifier", "cavp", "all"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--time", action="store_true",
                   help="also wall-clock each forward on the device")
    p.add_argument("--device", default=None,
                   help="the first CUDA device unless given (cpu)")
    return p.parse_args(argv)


def _report(name, model, fn, *args, do_time=False) -> dict:
    """Print the family's line (the JAX profiler's format); → its
    numbers."""
    costs = cost_analysis(fn, *args)
    n_params = count_params(model)
    out = {"params": n_params, **costs}
    line = (f"{name:12s} params={n_params/1e6:9.1f}M "
            f"flops={costs['flops']/1e9:10.2f}G "
            f"bytes={costs['bytes_accessed']/1e6:9.1f}MB")
    if do_time:
        sec, _ = timed_call(fn, *args, iters=TIME_ITERS)
        out.update(seconds=sec, tflops_per_second=costs["flops"] / sec / 1e12)
        line += (f" time={sec*1000:8.2f}ms "
                 f"tflops/s={costs['flops']/sec/1e12:7.1f}")
    print(line, flush=True)
    return out


@torch.no_grad()
def main(argv=None) -> dict:
    """→ {family line name: {"params", "flops", "bytes_accessed",
    "transcendentals"[, "seconds", "tflops_per_second"]}}."""
    args = parse_args(argv)
    b, fam, device = args.batch, args.family, resolve_device(args.device)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    results = {}

    def report(name, model, fn, *xs):
        results[name] = _report(name, model, fn, *xs, do_time=args.time)

    if fam in ("unet", "all"):
        with torch.device(device):
            unet = UNetModel(UNET_CFG)
        report("unet", unet, unet, zeros(b, *SHAPES["latent"]), zeros(b),
               zeros(b, *SHAPES["context"]))
        del unet
    if fam in ("vae", "all"):
        with torch.device(device):
            vae = AutoencoderKL(VAE_CFG)
        report("vae.encode", vae, lambda x: vae.encode(x).mode(),
               zeros(b, *SHAPES["spec"]))
        report("vae.decode", vae, vae.decode, zeros(b, *SHAPES["latent"]))
        del vae
    if fam in ("classifier", "all"):
        with torch.device(device):
            clf = ClassifierBackbone(CLASSIFIER_CFG)
        report("classifier", clf, clf, zeros(b, *SHAPES["latent"]), zeros(b),
               zeros(b, *SHAPES["clf_context"]))
        del clf
    if fam in ("cavp", "all"):
        with torch.device(device):
            cavp = CAVPModel(CAVP_CFG).eval()
        report("cavp", cavp, cavp, zeros(b, *SHAPES["video"]),
               zeros(b, *SHAPES["cavp_spec"]))
        del cavp
    return results


if __name__ == "__main__":
    main()
