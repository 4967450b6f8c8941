"""``utils/profiling.py`` and ``cli/profile.py`` on the CPU.

- ``count_params`` equals the JAX package's over the same tiny models'
  variables (the UNet, the VAE, the classifier, CAVP with its BatchNorm
  statistics), exactly.
- ``cost_analysis`` by its docstring's rules, exactly: a 128³ matmul is
  2·128³ flops; the tiny UNet's flops equal the formula over its
  convolutions, its Dense layers and its attention (4·B·H·Lq·Lk·D a call,
  counted once, whichever route ran: the plain version that stands in for
  the kernel here is hidden); the counts on ``meta`` equal those on the
  CPU; a GroupNorm call counts its kernel's bytes and SiLU's sigmoids.
- ``cli.profile --device cpu`` with tiny configs swapped in prints the
  JAX profiler's line per family and returns the same counts as
  ``cost_analysis`` on ``meta``.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from diff_foley_tpu.models import cavp as jc
from diff_foley_tpu.models import unet as ju
from diff_foley_tpu.models import vae as jv
from diff_foley_tpu.utils.profiling import count_params as j_count_params
from diff_foley_tpu_torch.cli import profile as profile_cli
from diff_foley_tpu_torch.models import cavp as tc
from diff_foley_tpu_torch.models import unet as tu
from diff_foley_tpu_torch.models import vae as tv
from diff_foley_tpu_torch.models.attention import CrossAttention
from diff_foley_tpu_torch.models.layers import Conv2d, Dense, GroupNorm32
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.utils.profiling import (cost_analysis, count_params,
                                                  flops_per_second,
                                                  timed_call, timed_chained,
                                                  timed_dispatch, trace)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

UCFG = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_heads=4, context_dim=24)
CLF = dict(out_channels=1, model_channels=32, num_res_blocks=1,
           channel_mult=(1, 2), attention_resolutions=(2,), num_heads=4,
           context_dim=16)
VCFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
CAVP_KW = dict(video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
               spec_channels=(8, 8, 16, 16, 32, 32), pool_kernel=2)


@pytest.mark.parametrize("family", ["unet", "vae", "classifier", "cavp"])
def test_count_params_equals_jax(family):
    key = jax.random.PRNGKey(0)
    if family == "unet":
        tree = jax.eval_shape(lambda: ju.UNetModel(ju.UNetConfig(**UCFG)).init(
            key, jnp.zeros((1, 8, 16, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 4, 24))))
        model = tu.UNetModel(tu.UNetConfig(**UCFG))
    elif family == "vae":
        tree = jax.eval_shape(lambda: jv.AutoencoderKL(
            jv.VAEConfig(**VCFG)).init(key, jnp.zeros((1, 16, 16, 3))))
        model = tv.AutoencoderKL(tv.VAEConfig(**VCFG))
    elif family == "classifier":
        tree = jax.eval_shape(lambda: ju.ClassifierBackbone(
            ju.UNetConfig(**CLF)).init(key, jnp.zeros((1, 8, 16, 4)),
                                       jnp.zeros((1,)), jnp.zeros((1, 4, 16))))
        model = tu.ClassifierBackbone(tu.UNetConfig(**CLF))
    else:
        tree = jax.eval_shape(lambda: jc.CAVPModel(jc.CAVPConfig(
            **CAVP_KW)).init(key, jnp.zeros((1, 5, 32, 32, 3)),
                             jnp.zeros((1, 128, 64)), train=False))
        assert "batch_stats" in tree
        model = tc.CAVPModel(tc.CAVPConfig(**CAVP_KW))
    assert count_params(model) == j_count_params(tree) > 0
    # a mapping of tensors counts its elements
    sd = dict(model.named_parameters())
    assert count_params(sd) == sum(p.numel() for p in sd.values())


def test_a_matmul_counts_two_flops_a_multiply_add():
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    cost = cost_analysis(torch.mm, a, b)
    assert cost["flops"] == 2 * 128**3
    assert cost["bytes_accessed"] == 3 * 128 * 128 * 4
    assert cost["transcendentals"] == 0


def test_elementwise_rules():
    x = torch.randn(1000)
    # exp: no product, one read and one write, a transcendental an element
    assert cost_analysis(torch.exp, x) == {
        "flops": 0.0, "bytes_accessed": 8000.0, "transcendentals": 1000.0}
    # a view moves nothing; x·x reads x once
    assert cost_analysis(lambda t: t.view(10, 100), x)["bytes_accessed"] == 0
    assert cost_analysis(lambda t: t * t, x)["bytes_accessed"] == 8000.0


def _formula(model, *args) -> int:
    """2·MAC of each convolution and Dense call and 4·B·H·Lq·Lk·D of each
    attention, from the shapes each module sees (forward hooks)."""
    total = [0]

    def conv(m, inp, out):
        co, ci, kh, kw = m.weight.shape
        total[0] += 2 * out.numel() * ci * kh * kw

    def dense(m, inp, out):
        total[0] += 2 * out.numel() * m.weight.shape[1]

    def attn(m, inp, out):
        x = inp[0]
        ctx = inp[1] if len(inp) > 1 and inp[1] is not None else x
        b, lq, _ = x.shape
        total[0] += 4 * b * lq * ctx.shape[1] * m.heads * m.dim_head

    hooks = []
    for m in model.modules():
        fn = {Conv2d: conv, Dense: dense, CrossAttention: attn}.get(type(m))
        if fn is not None:
            hooks.append(m.register_forward_hook(fn))
    with torch.no_grad():
        model(*args)
    for h in hooks:
        h.remove()
    return total[0]


def test_tiny_unet_flops_equal_the_formula_and_meta():
    model = tu.UNetModel(tu.UNetConfig(**UCFG))
    args = (torch.randn(2, 8, 16, 4), torch.tensor([10.0, 500.0]),
            torch.randn(2, 6, 24))
    with torch.no_grad():
        cost = cost_analysis(model, *args)
    assert cost["flops"] == _formula(model, *args) > 0
    with torch.device("meta"):
        meta = tu.UNetModel(tu.UNetConfig(**UCFG))
    with torch.no_grad():
        assert cost_analysis(meta, *(a.to("meta") for a in args)) == cost
    # the attention is counted by formula once: the plain version that
    # runs here would add its own two products if it were seen
    q, k, v = (torch.randn(2, 64, 128) for _ in range(3))
    att = cost_analysis(ha.attention_packed_fwd, q, k, v, 32**-0.5, 4)
    assert att == {"flops": 4.0 * 2 * 64 * 64 * 128,
                   "bytes_accessed": (2 * 64 + 2 * 64) * 2 * 128 * 4.0,
                   "transcendentals": 2.0 * 4 * 64 * 64}


def test_gradients_and_the_backward_kernel_count_by_formula():
    q, k, v = (torch.randn(2, 64, 128, requires_grad=True) for _ in range(3))

    def fwd_bwd():
        out = ha.FlashAttentionPacked.apply(q, k, v, 32**-0.5, 4)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    cost = cost_analysis(fwd_bwd)
    # forward 4·, backward 8·B·H·Lq·Lk·D; the ones_like fill and the
    # contiguous gradient move bytes of their own
    assert cost["flops"] == 12.0 * 2 * 64 * 64 * 128
    assert cost["transcendentals"] == 2 * 2.0 * 4 * 64 * 64


def test_groupnorm_counts_the_kernel_bytes():
    gn = GroupNorm32(64, act="silu")
    x = torch.randn(2, 64, 8, 8)
    with torch.no_grad():
        cost = cost_analysis(gn, x)
    assert cost == {"flops": 0.0, "bytes_accessed": 2.0 * x.numel() * 4,
                    "transcendentals": float(x.numel())}


def test_timers_and_trace(tmp_path):
    a = torch.randn(64, 64)
    sec, out = timed_call(torch.mm, a, a, iters=3)
    assert sec > 0 and out.shape == (64, 64)
    assert timed_chained(lambda x: x @ a, a, iters=2, chain=3) > 0
    assert timed_dispatch(torch.mm, a, a, iters=2) > 0
    fps = flops_per_second(torch.mm, a, a, iters=2)
    assert fps["flops"] == 2 * 64**3 and fps["tflops_per_second"] > 0
    with trace(str(tmp_path / "logs")):
        torch.mm(a, a)
    files = os.listdir(tmp_path / "logs")
    assert len(files) == 1 and files[0].endswith(".json")


def test_cli_profile_on_the_cpu_with_tiny_configs(monkeypatch, capsys):
    monkeypatch.setattr(profile_cli, "UNET_CFG", tu.UNetConfig(**UCFG))
    monkeypatch.setattr(profile_cli, "VAE_CFG", tv.VAEConfig(**VCFG))
    monkeypatch.setattr(profile_cli, "CLASSIFIER_CFG",
                        tu.UNetConfig(**{**CLF, "context_dim": 512}))
    monkeypatch.setattr(profile_cli, "CAVP_CFG", tc.CAVPConfig(**CAVP_KW))
    monkeypatch.setattr(profile_cli, "SHAPES", {
        "latent": (8, 16, 4), "context": (40, 24), "spec": (32, 64, 3),
        "clf_context": (40, 512), "video": (4, 32, 32, 3),
        "cavp_spec": (128, 64)})
    out = profile_cli.main(["--family", "all", "--batch", "2", "--time",
                            "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    names = ["unet", "vae.encode", "vae.decode", "classifier", "cavp"]
    assert list(out) == names and len(lines) == 5
    for name, line in zip(names, lines):
        assert line.split()[0] == name
        for field in ("params=", "flops=", "bytes=", "time=", "tflops/s="):
            assert field in line, line
        r = out[name]
        assert r["flops"] > 0 and r["seconds"] > 0 and r["params"] > 0
    # the UNet's count on meta, in this process, equals the CLI's
    with torch.device("meta"):
        meta = tu.UNetModel(tu.UNetConfig(**UCFG))
    z = lambda *s: torch.zeros(s, device="meta")
    with torch.no_grad():
        ref = cost_analysis(meta, z(2, 8, 16, 4), z(2), z(2, 40, 24))
    assert {k: out["unet"][k] for k in ref} == ref
    assert out["unet"]["params"] == count_params(meta)
