"""PyTorch port ops against the JAX package, on the CPU.

Inputs come from a numpy seed and go to both sides as numpy arrays. The
attention kernel module is held against the Pallas kernels themselves, run
in TPU interpret mode as tests/test_pallas_attention.py runs them; on CPU
tensors the port's wrappers run their plain versions.
"""
import ctypes
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.audio import transforms as jtr
from diff_foley_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from diff_foley_tpu.diffusion.schedule import timestep_embedding as j_temb
from diff_foley_tpu.ops import mel as jmel
from diff_foley_tpu.ops import pallas_attention as pa
from diff_foley_tpu.ops.attention import multi_head_attention as j_mha
from diff_foley_tpu_torch.audio import transforms as ttr
from diff_foley_tpu_torch.diffusion.schedule import DiffusionSchedule
from diff_foley_tpu_torch.diffusion.schedule import timestep_embedding
from diff_foley_tpu_torch.ops import cuda_build
from diff_foley_tpu_torch.ops import griffin_lim as tgl
from diff_foley_tpu_torch.ops import hopper_attention as ha
from diff_foley_tpu_torch.ops import hopper_groupnorm as hg
from diff_foley_tpu_torch.ops import mel as tmel
from diff_foley_tpu_torch.ops import stft as tstft
from diff_foley_tpu_torch.ops.attention import (multi_head_attention,
                                                multi_head_attention_packed)

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# diff_foley_tpu.ops re-exports functions named like these modules
jgl = importlib.import_module("diff_foley_tpu.ops.griffin_lim")
jstft = importlib.import_module("diff_foley_tpu.ops.stft")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, tol, what=""):
    """max|Δ| ≤ tol · max(1, max|ref|)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.abs(out - ref).max()
    scale = max(1.0, np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3e} > {tol:.1e}·{scale:.3g}"


@pytest.fixture
def interpret_mode():
    """Pallas kernels in TPU interpret mode on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# (b, heads, lq, lk, d): the classifier's head dim 32, the UNet level-0 head
# dim 40, and a ragged shape
ATTN_SHAPES = [(2, 4, 64, 32, 40), (1, 8, 128, 128, 32), (2, 2, 100, 30, 40)]


@pytest.mark.parametrize("b,heads,lq,lk,d", ATTN_SHAPES)
def test_packed_attention_forward_matches_pallas(interpret_mode, b, heads, lq,
                                                 lk, d):
    # fp32 both sides; only the order of the sums differs (Pallas' own
    # packed test holds 2e-5)
    rng = np.random.default_rng(10)
    q, k, v = (rng.standard_normal((b, n, heads * d)).astype(np.float32)
               for n in (lq, lk, lk))
    ref = pa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), d**-0.5, heads)
    out = multi_head_attention_packed(_t(q), _t(k), _t(v), heads)
    _close(out, ref, 2e-5, "packed forward")


@pytest.mark.parametrize("b,heads,lq,lk,d", ATTN_SHAPES)
def test_packed_attention_grad_matches_pallas(interpret_mode, b, heads, lq,
                                              lk, d):
    # ∇ of Σ w·attn(q, k, v) through the Pallas vjp against the port's
    # autograd.Function; fp32, 1e-4 as Pallas' own gradient test
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, n, heads * d)).astype(np.float32)
               for n in (lq, lk, lk))
    w = rng.standard_normal((b, lq, heads * d)).astype(np.float32)
    loss = lambda q_, k_, v_: jnp.sum(
        pa.flash_attention_packed(q_, k_, v_, d**-0.5, heads) * w)
    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (_t(a).requires_grad_(True) for a in (q, k, v))
    (ha.FlashAttentionPacked.apply(qt, kt, vt, d**-0.5, heads) * _t(w)).sum(
    ).backward()
    for name, t, r in zip("qkv", (qt, kt, vt), refs):
        _close(t.grad, r, 1e-4, f"d{name}")


def test_packed_backward_reference_matches_xla_bwd():
    # the plain backward is _xla_bwd's formula, split and merged over heads
    rng = np.random.default_rng(12)
    b, heads, lq, lk, d = 2, 4, 48, 20, 32
    q, k, v, g = (rng.standard_normal((b, n, heads * d)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    refs = pa._xla_bwd(d**-0.5, *(pa._split_heads(jnp.asarray(a), heads)
                                  for a in (q, k, v, g)))
    outs = ha.attention_packed_bwd(_t(q), _t(k), _t(v), _t(g), d**-0.5, heads)
    for o, r in zip(outs, refs):
        _close(o, pa._merge_heads(r), 1e-5, "plain backward")


def test_multi_head_attention_matches_xla():
    # the plain (B, H, L, D) formula of the VAE's mid attention
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((2, 1, 64, 48)).astype(np.float32)
               for _ in range(3))
    ref = j_mha(*map(jnp.asarray, (q, k, v)), backend="xla")
    _close(multi_head_attention(_t(q), _t(k), _t(v)), ref, 1e-5, "mha")


# (b, heads, l, d) of the per-head kernel: the SD VAE's D 512 at a small L
# (the Pallas kernel fits VMEM there), and the tiny VAE (ch 32) of
# chip_smoke.py's agreement run at the full latent's 1024 tokens
PER_HEAD_SHAPES = [(1, 1, 64, 512, "_pallas_forward"),
                   (2, 1, 1024, 32, "flash_attention")]


@pytest.mark.parametrize("b,heads,l,d,oracle", PER_HEAD_SHAPES)
def test_per_head_attention_matches_pallas(interpret_mode, b, heads, l, d,
                                           oracle):
    # fp32; the port gets the VAE's layout, the token view of NCHW
    # projections (B, H, L, D) with D the slow axis. 2e-5, as the packed
    # forward
    rng = np.random.default_rng(19)
    q, k, v = (rng.standard_normal((b, heads, l, d)).astype(np.float32)
               for _ in range(3))
    ref = getattr(pa, oracle)(*map(jnp.asarray, (q, k, v)), d**-0.5)
    view = lambda a: _t(a.transpose(0, 1, 3, 2).copy()).transpose(2, 3)
    out = multi_head_attention(view(q), view(k), view(v))
    _close(out, ref, 2e-5, oracle)


def test_per_head_wrapper_takes_the_path_layouts():
    meta = torch.empty(2, 1, 64, 512, device="meta")
    tok = torch.empty(2, 1, 512, 64, device="meta").transpose(2, 3)
    assert ha._check_per_head(meta, meta, meta) == 512
    assert ha._check_per_head(tok, tok, tok) == 512
    gapped = torch.empty(2, 1, 64, 1024, device="meta")[..., ::2]
    with pytest.raises(ValueError, match="neither"):
        ha._check_per_head(gapped, meta, meta)
    # q, k and v may each lie in either layout, forward and backward alike
    assert ha._check_per_head(meta, meta, tok) == 512
    assert ha._check_per_head(tok, meta, meta) == 512
    odd = torch.empty(2, 1, 64, 128, device="meta")
    with pytest.raises(ValueError, match="head dim 128"):
        ha._check_per_head(odd, odd, odd)


def _token_view(a):
    """(B, H, L, D) numpy → the same values as the token view of an NCHW
    map: D the slow axis, stride 1 along L."""
    return _t(a.transpose(0, 1, 3, 2).copy()).transpose(2, 3)


# (b, heads, lq, lk, d, layout): Pallas' own gradient shape, Lq ≠ Lk at the
# tiny VAE's head dim in the VAE's NCHW-token strides, and a ragged shape
PER_HEAD_GRAD_SHAPES = [(1, 2, 32, 16, 40, "rows"),
                        (2, 1, 64, 24, 32, "tokens"),
                        (2, 2, 100, 30, 16, "tokens")]


@pytest.mark.parametrize("b,heads,lq,lk,d,layout", PER_HEAD_GRAD_SHAPES)
def test_per_head_attention_grad_matches_pallas(interpret_mode, b, heads, lq,
                                                lk, d, layout):
    # ∇ of Σ w·attn(q, k, v) through flash_attention's vjp (interpret mode)
    # against the port's FlashAttention; fp32, 1e-4 as Pallas' own
    # gradient test
    rng = np.random.default_rng(20)
    q, k, v = (rng.standard_normal((b, heads, n, d)).astype(np.float32)
               for n in (lq, lk, lk))
    w = rng.standard_normal((b, heads, lq, d)).astype(np.float32)
    loss = lambda q_, k_, v_: jnp.sum(
        pa.flash_attention(q_, k_, v_, d**-0.5) * w)
    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    view = _token_view if layout == "tokens" else _t
    qt, kt, vt = (view(a).requires_grad_(True) for a in (q, k, v))
    out = multi_head_attention(qt, kt, vt)
    grads = torch.autograd.grad((out * _t(w)).sum(), (qt, kt, vt))
    for name, g, r in zip("qkv", grads, refs):
        _close(g, r, 1e-4, f"d{name}")


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 6e-2)])
def test_per_head_backward_reference_matches_pallas_backward(interpret_mode,
                                                             dtype, tol):
    # the plain backward against the TPU kernel itself, two query chunks
    # (Lq 1024 → chunks of 512), Lq ≠ Lk; the limits of Pallas' own
    # backward tests: fp32 2e-4, bf16 6e-2
    rng = np.random.default_rng(21)
    b, heads, lq, lk, d = 1, 2, 1024, 64, 32
    q, k, v, g = (rng.standard_normal((b, heads, n, d)).astype(np.float32)
                  for n in (lq, lk, lk, lq))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    refs = pa._pallas_backward(*(jnp.asarray(a, jd) for a in (q, k, v, g)),
                               d**-0.5)
    outs = ha.attention_bwd(*(_t(a).to(td) for a in (q, k, v, g)), d**-0.5)
    for name, o, r in zip("qkv", outs, refs):
        assert o.dtype == td
        _close(o.float(), np.asarray(r.astype(jnp.float32)), tol, f"d{name}")


def test_per_head_backward_wrapper_checks():
    # k and v may differ in layout for the backward; a tensor that lies
    # neither on the CPU nor on a CUDA device raises
    meta = torch.empty(2, 1, 64, 512, device="meta")
    tok = torch.empty(2, 1, 512, 64, device="meta").transpose(2, 3)
    assert ha._check_per_head(meta, tok, meta) == 512
    gapped = torch.empty(2, 1, 64, 1024, device="meta")[..., ::2]
    with pytest.raises(ValueError, match="neither"):
        ha._check_per_head(meta, tok, gapped)
    with pytest.raises(ValueError, match="CPU or all on"):
        ha.attention_bwd(meta, meta, meta, meta, 1.0)


def test_schedule_tables_match():
    # both sides round the same float64 tables to float32: exact
    j = JSchedule.create(timesteps=1000, linear_start=0.00085,
                         linear_end=0.0120)
    t = DiffusionSchedule.create(timesteps=1000, linear_start=0.00085,
                                 linear_end=0.0120)
    for name in ("betas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)), name)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches(dim):
    # times up to 999 rad: one float32 ulp of a frequency moves cos/sin by
    # ~1e-4, so 2e-4
    ts = np.array([0.0, 1.5, 250.0, 999.0], np.float32)
    _close(timestep_embedding(_t(ts), dim), j_temb(jnp.asarray(ts), dim),
           2e-4, "timestep embedding")


def test_mel_filterbank_matches():
    np.testing.assert_array_equal(
        tmel.mel_filterbank().numpy(), np.asarray(jmel.mel_filterbank()))


@pytest.mark.parametrize("rdft", ["fft", "matmul"])
def test_stft_istft_match(rdft):
    # torch.fft against XLA's FFT or the fp32 DFT matmuls: 1e-4 of the
    # largest bin
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    ref = jstft.stft(jnp.asarray(x), rdft=rdft)
    out = tstft.stft(_t(x))
    _close(out.real, np.real(ref), 1e-4, "stft re")
    _close(out.imag, np.imag(ref), 1e-4, "stft im")
    spec = np.asarray(ref)
    y = tstft.istft(_t(spec), length=8192)
    _close(y, jstft.istft(jnp.asarray(spec), length=8192, rdft=rdft), 1e-4,
           "istft")


def test_spectrogram_normalisation_matches():
    rng = np.random.default_rng(15)
    mel = np.abs(rng.standard_normal((2, 16, 8))).astype(np.float32) * 3
    _close(ttr.normalize_spectrogram(_t(mel)),
           jtr.normalize_spectrogram(jnp.asarray(mel)), 1e-6, "normalize")
    spec = rng.uniform(size=(2, 16, 8)).astype(np.float32)
    _close(ttr.denormalize_spectrogram(_t(spec)),
           jtr.denormalize_spectrogram(jnp.asarray(spec)), 1e-5, "denorm")


def _spec(frames: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.2, 0.9, size=(2, 128, frames)).astype(np.float32)


def test_mel_to_stft_matches():
    # 30 power iterations and 60 FISTA steps in fp32 on both sides
    mel = np.asarray(jtr.denormalize_spectrogram(jnp.asarray(_spec(16, 16))))
    _close(tgl.mel_to_stft(_t(mel)), jgl.mel_to_stft(jnp.asarray(mel)), 1e-4,
           "mel_to_stft")


def test_griffin_lim_matches_with_shared_phase():
    # the JAX phase draw, handed to the port; 8 momentum iterations keep
    # the fp32 FFT-vs-matmul differences at ~1e-5 of the signal
    rng = np.random.default_rng(17)
    mag = np.abs(rng.standard_normal((2, 513, 24))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    phase = np.asarray(jax.random.uniform(key, mag.shape, dtype=jnp.float32))
    ref = jgl.griffin_lim(jnp.asarray(mag), key, n_iter=8, length=6000)
    out = tgl.griffin_lim(_t(mag), phase=_t(phase), n_iter=8, length=6000)
    _close(out, ref, 1e-3, "griffin_lim")


def test_mel_to_wav_matches_with_shared_phase():
    spec = _spec(24, 18)
    key = jax.random.PRNGKey(4)
    phase = np.asarray(jax.random.uniform(key, (2, 513, 24),
                                          dtype=jnp.float32))
    ref = jtr.mel_to_wav(jnp.asarray(spec), key, n_iter=8, length=6144)
    out = ttr.mel_to_wav(_t(spec), n_iter=8, length=6144, phase=_t(phase))
    _close(out, ref, 1e-3, "mel_to_wav")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(kind, dtype):
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    b, heads, lq, lk, d = 2, 8, 200, 72, 40
    q, k, v, g = (torch.randn((b, n, heads * d), generator=gen,
                              device="cuda").to(dtype)
                  for n in (lq, lk, lk, lq))
    before = dict(ha.LAUNCHES)
    if kind == "fwd":
        outs = (ha.attention_packed_fwd(q, k, v, d**-0.5, heads),)
        refs = (ha.attention_packed_reference(q, k, v, d**-0.5, heads),)
    else:
        outs = ha.attention_packed_bwd(q, k, v, g, d**-0.5, heads)
        refs = _packed_backward_yardstick(q, k, v, g, d**-0.5, heads)
    torch.cuda.synchronize()
    assert ha.LAUNCHES[f"attn_packed_{kind}"] == before[
        f"attn_packed_{kind}"] + 1
    # max|Δ| and rms(Δ) against rms(plain), the limits chip_smoke.py holds
    # the path's shapes to (a few times what the kernels reach there)
    max_tol, rms_tol = {
        ("fwd", torch.float32): (5e-6, 3e-7), ("bwd", torch.float32): (1e-5, 5e-7),
        ("fwd", torch.bfloat16): (0.06, 4e-4),
        ("bwd", torch.bfloat16): (0.25, 0.015)}[(kind, dtype)]
    for o, r in zip(outs, refs):
        assert o.dtype == dtype
        o, r = o.double(), r.double()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= max_tol * rms
        assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.parametrize("d,ok", [(32, True), (40, True), (80, True),
                                  (160, True), (64, True), (48, True),
                                  (96, True), (16, False), (20, False),
                                  (128, False), (512, False)])
def test_kernel_wrappers_take_the_path_head_dims(d, ok):
    # the CUDA sources instantiate the path's head dims only
    heads = 2
    q = torch.zeros((1, 4, heads * d))
    if ok:
        assert ha._check_packed(q, q, q, heads) == d
    else:
        with pytest.raises(ValueError, match="does not split"):
            ha._check_packed(q, q, q, heads)


# ---- the arithmetic of the tensor-core kernels, modelled on the CPU ---------
#
# csrc/attention_head_bwd.cu computes fp32 products on the TF32 tensor cores
# by 3xTF32: x = big + small, big = x rounded to nearest (ties away from
# zero, as PTX cvt.rna.tf32.f32) onto TF32's 10 mantissa bits, small =
# x − big (exact in fp32), which the tensor cores read truncated to TF32;
# each product is small·big + big·small + big·big. A product of two TF32
# values is exact in fp32, and the kernel sums each 32-deep k-tile in fp32
# before adding it into its fp32 accumulator. The model below repeats
# exactly that in numpy: the roundings by bit operations on the int32
# view, the products in fp32, the k-tile sums and their accumulation in
# fp32.


def _tf32_rna(x):
    """x (float32) rounded to nearest, ties away from zero, onto 10 mantissa
    bits: the low 13 bits of the magnitude rounded off."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _tf32_trunc(x):
    """x (float32) as the tensor cores read it: the low 13 bits dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.int32)
    return (bits & ~0x1FFF).view(np.float32)


def _split_tf32(x):
    big = _tf32_rna(x)
    return big, _tf32_trunc((x - big).astype(np.float32))


def _tf32_matmul(a, b, terms: int):
    """a (M, K) · b (K, N) as the kernel computes it: 3xTF32 (terms 3) or a
    single TF32 product (terms 1), fp32 sums of 32-deep k-tiles accumulated
    in fp32."""
    ab, asm = _split_tf32(a)
    bb, bsm = _split_tf32(b)
    pairs = ([(asm, bb), (ab, bsm), (ab, bb)] if terms == 3 else
             [(ab, bb)])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 32):
        part = np.zeros_like(acc)
        for x, y in pairs:
            part += (x[:, k0:k0 + 32, None] * y[None, k0:k0 + 32]).sum(
                1, dtype=np.float32)
        acc += part
    return acc


def test_tf32_split_rebuilds_fp32():
    # big + small (as read) carries x to 2⁻²¹ of |x| and to ~2⁻²² in the
    # mean; big alone to 2⁻¹¹ only
    x = np.random.default_rng(30).standard_normal(1 << 16).astype(np.float32)
    big, small = _split_tf32(x)
    assert np.all(_tf32_trunc(big) == big)
    assert np.all(_tf32_trunc(small) == small)
    rel = lambda y: np.abs(y - x.astype(np.float64)) / np.abs(x)
    assert rel(big.astype(np.float64)).max() <= 2.0**-11
    assert rel(big.astype(np.float64)).max() > 2.0**-13
    both = rel(big.astype(np.float64) + small)
    assert both.max() <= 2.0**-21 and both.mean() <= 2.0**-22


@pytest.mark.parametrize("depth", [512, 1024])
def test_3xtf32_products_hold_the_fp32_limits(depth):
    """3-term TF32 products of the backward's depths (D 512 for the scores,
    L 1024 for dQ, dK, dV) agree with fp64 well inside the fp32 limits the
    smoke holds the per-head backward to (max|Δ| 2e-5 and rms(Δ) 1.5e-6 of
    rms(ref)), as closely as fp32 products summed the same way (within
    1.25×; both reach ~1.5e-7 rms); one TF32 product does not."""
    rng = np.random.default_rng(31)
    a = rng.standard_normal((32, depth)).astype(np.float32)
    b = rng.standard_normal((depth, 32)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rms = np.sqrt((ref**2).mean())

    def ratios(out):
        d = np.abs(out - ref)
        return d.max() / rms, np.sqrt((d**2).mean()) / rms

    fp32 = np.zeros((32, 32), np.float32)
    for k0 in range(0, depth, 32):
        fp32 += (a[:, k0:k0 + 32, None] * b[None, k0:k0 + 32]).sum(
            1, dtype=np.float32)
    max3, rms3 = ratios(_tf32_matmul(a, b, 3))
    assert max3 <= 2e-5 / 5 and rms3 <= 1.5e-6 / 5, (max3, rms3)
    assert rms3 <= 1.25 * ratios(fp32)[1], (rms3, ratios(fp32))
    max1, rms1 = ratios(_tf32_matmul(a, b, 1))
    assert max1 > 2e-5 and rms1 > 1.5e-6, (max1, rms1)


@pytest.mark.parametrize("dtype,lk,lds,mib", [
    (torch.float32, 1024, 1024, 64.0), (torch.bfloat16, 1024, 1024, 48.0),
    (torch.float32, 936, 936, 64.0 * 936 / 1024), (torch.float32, 30, 32,
                                                   2.0)])
def test_per_head_backward_scratch(dtype, lk, lds, mib):
    # S and g·Vᵀ in fp32, P̃ and dS in the operand type, rows of lds
    # elements (Lk rounded up to 8: 16-byte aligned in both types)
    assert ha.scratch_ld(lk) == lds
    t = ha.head_bwd_scratch(4, 1, 1024, lk, dtype, "meta")
    assert t.dtype == torch.float32 and t.dim() == 1
    assert t.numel() * 4 == 4 * 1024 * lds * (8 + 2 * dtype.itemsize)
    assert t.numel() * 4 / 2**20 == mib


@pytest.mark.parametrize("lq,lk,dtype,fp64", [
    (32, 1024, torch.float32, True), (33, 1024, torch.float32, False),
    (1, 65, torch.float32, True), (1024, 7, torch.float32, True),
    (1024, 8, torch.float32, False), (16, 16, torch.bfloat16, False)])
def test_backward_over_few_queries_runs_in_fp64(lq, lk, dtype, fp64):
    # fp32 over at most 32 queries (the AR encoder's 32 video tokens
    # against 1024 latent keys, the prior's and the spec decoder's 16, the
    # pool's one) or under 8 keys: S, dP, P and dS in fp64 (32 bytes an
    # entry), else S and dP in fp32 and P̃, dS in the operand type
    assert ha.fp64_backward(dtype, lq, lk) == fp64
    t = ha.head_bwd_scratch(2, 8, lq, lk, dtype, "meta")
    per = 32 if fp64 else 8 + 2 * dtype.itemsize
    assert t.dtype == torch.float32
    assert t.numel() * 4 == 2 * 8 * lq * ha.scratch_ld(lk) * per
    # the rule's constants are the CUDA source's
    src = (cuda_build.CSRC / "head_bwd.cuh").read_text()
    assert re.search(r"constexpr int FEW_QUERIES = (\d+);", src).group(1) \
        == str(ha._FEW_QUERIES)
    assert re.search(r"constexpr int SHALLOW_K = (\d+);", src).group(1) \
        == str(ha._SHALLOW_K)


@pytest.mark.parametrize("d", [32, 40, 80, 160])
def test_packed_backward_reads_heads_in_place(d):
    # the packed backward hands each head of a contiguous (B, L, H·D)
    # operand to csrc/head_bwd.cuh as the view (B, H, L, D) with strides
    # (L·H·D, D, H·D, 1), no copy; its 16-byte copies take those strides in
    # both types, and the scratch is the per-head backward's for (B, H, Lq,
    # Lk): 24 MiB in bf16 at the classifier's (4, 8, 256, 256)
    b, heads, l = 4, 8, 256
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.zeros((b, l, heads * d), dtype=dtype)
        view = ha.split_heads(t, heads)
        assert view.shape == (b, heads, l, d)
        assert view.stride() == ha.packed_head_strides(l, heads, d) == (
            l * heads * d, d, heads * d, 1)
        assert view.data_ptr() == t.data_ptr()
        assert ha._cp_async_ready(view)
        assert torch.equal(ha.merge_heads(view), t)
        scratch = ha.head_bwd_scratch(b, heads, l, l, dtype, "meta")
        assert scratch.numel() * 4 == b * heads * l * l * (8 + 2 * dtype.itemsize)
    assert ha.head_bwd_scratch(b, heads, l, l, torch.bfloat16,
                               "meta").numel() * 4 / 2**20 == 24.0
    # a ragged Lk pads the scratch rows to 8 elements: 72 → 72, 30 → 32
    assert ha.head_bwd_scratch(2, heads, 200, 30, torch.float32,
                               "meta").numel() == 2 * heads * 200 * 32 * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lk,lds,mib", [(1024, 1024, 16.0),
                                        (936, 936, 16.0 * 936 / 1024),
                                        (30, 32, 0.5)])
def test_per_head_forward_scratch(dtype, lk, lds, mib):
    # S in fp32 with rows of lds elements (Lk rounded up to 8); the row
    # pass writes P̃ in the operand type over each row's own scores, so one
    # size serves both types and P̃'s rows, lds·4 bytes apart, start
    # 16-byte aligned and hold Lk elements
    t = ha.head_fwd_scratch(4, 1, 1024, lk, "meta")
    assert t.dtype == torch.float32 and t.dim() == 1
    assert t.numel() == 4 * 1024 * lds and t.numel() * 4 / 2**20 == mib
    pt = t.view(dtype).view(4 * 1024, -1)
    assert pt.stride(0) * dtype.itemsize == lds * 4
    assert lds * 4 % 16 == 0 and pt.shape[1] >= lk


def test_attention_reference_keeps_float64():
    # float64 operands stay float64 (the exact yardstick of the fp32
    # kernel on the card) and agree with the fp32 evaluation
    rng = np.random.default_rng(32)
    q, k, v = (_t(rng.standard_normal((2, 1, n, 32)).astype(np.float32))
               for n in (72, 40, 40))
    ref32 = ha.attention_reference(q, k, v, 32**-0.5)
    ref64 = ha.attention_reference(q.double(), k.double(), v.double(),
                                   32**-0.5)
    assert ref32.dtype == torch.float32 and ref64.dtype == torch.float64
    rms = float(ref64.square().mean().sqrt())
    assert float((ref32.double() - ref64).abs().max()) <= 1e-5 * rms


def _c_entries():
    """{name: (source, [argument kinds])} of every ``extern "C" int dft_*``
    in csrc/*.cu, each parameter a pointer, an int, a long long or a
    float."""
    out = {}
    for path in sorted(cuda_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (dft_\w+)\((.*?)\)',
                                       path.read_text(), re.S):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                kinds.append("ptr" if "*" in p else "longlong"
                             if p.startswith("long long") else
                             p.split()[0])
            out[name] = (path.stem, kinds)
    return out


def test_ctypes_argtypes_match_the_c_entries():
    # a wrong argtypes cuts a pointer or a long long silently: every C
    # entry's parameters, by count and kind, against the wrappers' tables
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_longlong: "longlong", ctypes.c_float: "float"}
    tables = {**ha._ENTRIES, **{fn: ("groupnorm", types)
                                for fn, types in hg._ARGTYPES.items()}}
    entries = _c_entries()
    assert sorted(entries) == sorted(tables)
    for fn, (source, types) in tables.items():
        assert entries[fn] == (source, [kind[t] for t in types]), fn
    assert len(entries["dft_attn_fwd"][1]) == 5 + 5 + 16 + 3


def test_cp_async_ready_operands():
    # the 16-byte copies need the address and every stride other than 1
    # (over an axis longer than 1) on 16-byte multiples; the VAE's token
    # views at L 1024 and 936 qualify in both types, L 100 in bf16 does not
    for dtype in (torch.float32, torch.bfloat16):
        for l in (1024, 936):
            tok = torch.zeros((2, 512, l), dtype=dtype)[:, None]
            assert ha._cp_async_ready(tok.transpose(2, 3))
        assert ha._cp_async_ready(torch.zeros((2, 1, 72, 32), dtype=dtype))
    odd = torch.zeros((2, 32, 100), dtype=torch.bfloat16)[:, None]
    assert not ha._cp_async_ready(odd.transpose(2, 3))
    assert ha._cp_async_ready(odd.float().transpose(2, 3))
    assert not ha._cp_async_ready(torch.zeros(4 * 2 * 320 + 1)[1:])


@pytest.mark.parametrize("d,ok", [(32, True), (512, True), (256, True),
                                  (40, False), (64, True), (128, False),
                                  (48, False)])
def test_per_head_wrappers_take_head_dims_32_and_512(d, ok):
    # csrc/attention_head_{fwd,bwd}.cu take the VAE's 512, the spec
    # decoder's 256, the prior's 64 and the tiny VAEs' and the attention
    # pool's 32 only
    t = torch.empty(1, 1, 64, d, device="meta")
    if ok:
        assert ha._check_per_head(t, t, t) == d
    else:
        with pytest.raises(ValueError, match=f"head dim {d}"):
            ha._check_per_head(t, t, t)


def test_wrappers_reject_mismatched_shapes():
    # k and v must match q in B, H and D (per head) or in B and H·D
    # (packed); the kernels take no other shapes
    q = torch.empty(2, 1, 64, 512, device="meta")
    for k in (torch.empty(2, 1, 64, 32, device="meta"),
              torch.empty(1, 1, 64, 512, device="meta")):
        with pytest.raises(ValueError, match="must match"):
            ha._check_per_head(q, k, k)
    q3 = torch.zeros((1, 4, 2 * 40))
    with pytest.raises(ValueError, match="do not match"):
        ha._check_packed(q3, torch.zeros((1, 4, 2 * 32)), q3, 2)


def _forward_yardstick(q, k, v, scale):
    """What the per-head forward kernel is held to on the card: the plain
    version in bf16; for fp32 the plain version on float64 copies (the
    kernel sums on the tensor cores in another order than cuBLAS)."""
    if q.dtype == torch.float32:
        q, k, v = (t.double() for t in (q, k, v))
    return ha.attention_reference(q, k, v, scale)


def _backward_yardstick(q, k, v, g, scale):
    """What the per-head backward kernel is held to on the card: the plain
    version in bf16; for fp32 the plain version on float64 copies. The
    kernel's fp32 sums run on the tensor cores in another order than
    cuBLAS's fp32 products in the plain version, whose own error reaches
    2.5e-5 of rms at the VAE's shape, beyond the limit."""
    if q.dtype == torch.float32:
        q, k, v, g = (t.double() for t in (q, k, v, g))
    return ha.attention_backward_reference(q, k, v, g, scale)


def _packed_backward_yardstick(q3, k3, v3, g3, scale, heads):
    """What the packed backward kernel is held to on the card, as the
    per-head one (``_backward_yardstick``): the plain version in bf16, for
    fp32 the plain version on float64 copies."""
    if q3.dtype == torch.float32:
        q3, k3, v3, g3 = (t.double() for t in (q3, k3, v3, g3))
    return ha.attention_packed_backward_reference(q3, k3, v3, g3, scale,
                                                  heads)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 40, 48, 80, 96, 160])
@pytest.mark.parametrize("lq,lk", [(200, 72), (130, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packed_backward_head_dims(dtype, d, lq, lk):
    """The packed backward (tensor cores, csrc/head_bwd.cuh over the packed
    heads) at each path head dim, Lq ≠ Lk off the 64-row tiles and the
    cross-attention's single key tile (Lk 32), one launch a call, against
    the yardstick at chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(d + lq)
    heads = 4
    q, k, v, g = (torch.randn((2, n, heads * d), generator=gen,
                              device="cuda").to(dtype)
                  for n in (lq, lk, lk, lq))
    before = ha.LAUNCHES["attn_packed_bwd"]
    outs = ha.attention_packed_bwd(q, k, v, g, d**-0.5, heads)
    refs = _packed_backward_yardstick(q, k, v, g, d**-0.5, heads)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["attn_packed_bwd"] == before + 1
    max_tol, rms_tol = {torch.float32: (1e-5, 5e-7),
                        torch.bfloat16: (0.25, 0.015)}[dtype]
    for o, r, t in zip(outs, refs, (q, k, v)):
        assert o.dtype == dtype and o.shape == t.shape and o.is_contiguous()
        o, r = o.double(), r.double()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= max_tol * rms
        assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 40, 48, 80, 96, 160])
@pytest.mark.parametrize("lq,lk", [(200, 72), (130, 32)])
def test_cuda_packed_forward_bf16_head_dims(d, lq, lk):
    """The bf16 tensor-core forward at each path head dim, with Lq and Lk
    off the 64-row tiles and the cross-attention's single key tile (Lk 32),
    against its plain version, at chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(d + lk)
    heads = 4
    q, k, v = (torch.randn((2, n, heads * d), generator=gen, device="cuda")
               .to(torch.bfloat16) for n in (lq, lk, lk))
    out = ha.attention_packed_fwd(q, k, v, d**-0.5, heads)
    ref = ha.attention_packed_reference(q, k, v, d**-0.5, heads)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    o, r = out.float(), ref.float()
    rms = float(r.square().mean().sqrt())
    assert float((o - r).abs().max()) <= 0.06 * rms
    assert float((o - r).square().mean().sqrt()) <= 4e-4 * rms


# The UNet's attention in stage-2 training: the train batch 16, self
# attention at L 1024/256/64/16 with D 40/80/160/160 and cross attention
# over the 32 condition tokens of an 8.192-s crop
S2_SHAPES = [(1024, 1024, 40), (1024, 32, 40), (256, 256, 80),
             (256, 32, 80), (64, 64, 160), (64, 32, 160), (16, 16, 160),
             (16, 32, 160)]


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk,d", S2_SHAPES)
def test_cuda_packed_attention_stage2_shapes(lq, lk, d):
    """The bf16 packed forward and backward at each stage-2 train shape,
    one launch a call each, against their plain versions at chip_smoke.py's
    limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(lq + lk + d)
    heads = 8
    q, k, v, g = (torch.randn((16, n, heads * d), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for n in (lq, lk, lk, lq))
    before = dict(ha.LAUNCHES)
    out = ha.attention_packed_fwd(q, k, v, d**-0.5, heads)
    grads = ha.attention_packed_bwd(q, k, v, g, d**-0.5, heads)
    torch.cuda.synchronize()
    for kind in ("fwd", "bwd"):
        key = f"attn_packed_{kind}"
        assert ha.LAUNCHES[key] == before[key] + 1
    pairs = [((out,), (ha.attention_packed_reference(q, k, v, d**-0.5,
                                                     heads),), 0.06, 4e-4),
             (grads, _packed_backward_yardstick(q, k, v, g, d**-0.5, heads),
              0.25, 0.015)]
    for outs, refs, max_tol, rms_tol in pairs:
        for o, r in zip(outs, refs):
            assert o.dtype == torch.bfloat16
            o, r = o.double(), r.double()
            rms = float(r.square().mean().sqrt())
            assert float((o - r).abs().max()) <= max_tol * rms
            assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tokens", "rows", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_per_head_backward_ragged_vae(dtype, layout):
    """The per-head backward at the VAE's head dim with Lq 1000 and Lk 936,
    off the 64-row tiles: both layouts, and k, v and a gradient dense in
    neither layout mixed ("mixed"), at chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(4)
    tokens = lambda l: torch.randn((2, 1, 512, l), generator=gen,
                                   device="cuda").to(dtype).transpose(2, 3)
    rows = lambda l: torch.randn((2, 1, l, 512), generator=gen,
                                 device="cuda").to(dtype)
    if layout == "mixed":
        q, k, v = tokens(1000), rows(936), tokens(936)
        g = torch.randn((2, 1, 1000, 1024), generator=gen,
                        device="cuda").to(dtype)[..., ::2]
    else:
        make = tokens if layout == "tokens" else rows
        q, k, v, g = make(1000), make(936), make(936), make(1000)
    outs = ha.attention_bwd(q, k, v, g, 512**-0.5)
    refs = _backward_yardstick(q, k, v, g, 512**-0.5)
    torch.cuda.synchronize()
    max_tol, rms_tol = {torch.float32: (2e-5, 1.5e-6),
                        torch.bfloat16: (0.25, 0.015)}[dtype]
    for o, r, t in zip(outs, refs, (q, k, v)):
        assert o.dtype == dtype and o.stride() == t.stride()
        o, r = o.double(), r.double()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= max_tol * rms
        assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


def _forward_limits(out, ref, dtype):
    """chip_smoke.py's limits for the per-head forward: max|Δ| and rms(Δ)
    against rms(yardstick)."""
    max_tol, rms_tol = {torch.float32: (1.5e-5, 1e-6),
                        torch.bfloat16: (0.06, 4e-4)}[dtype]
    o, r = out.double(), ref.double()
    rms = float(r.square().mean().sqrt())
    assert float((o - r).abs().max()) <= max_tol * rms
    assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.gpu
@pytest.mark.parametrize("d,l", [(512, 1024), (32, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_per_head_kernel_matches_plain(dtype, d, l):
    """The per-head kernel through ``multi_head_attention`` against its
    plain version on the card in the VAE's layout: the SD VAE's shape, and
    the tiny agreement VAE's (D 32, 8·17 tokens); its launch count and the
    strides of what it returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((2, d, l), generator=gen, device="cuda")
               .to(dtype)[:, None].transpose(2, 3) for _ in range(3))
    before = ha.LAUNCHES["attn_fwd"]
    out = multi_head_attention(q, k, v)
    ref = _forward_yardstick(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["attn_fwd"] == before + 1
    assert out.dtype == dtype and out.stride() == q.stride()
    _forward_limits(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tokens", "rows", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_per_head_forward_ragged_vae(dtype, layout):
    """The per-head forward at the VAE's head dim with Lq 1000 and Lk 936,
    off the 64-row tiles: both layouts, and q, k and v mixed ("mixed"), at
    chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(5)
    tokens = lambda l: torch.randn((2, 1, 512, l), generator=gen,
                                   device="cuda").to(dtype).transpose(2, 3)
    rows = lambda l: torch.randn((2, 1, l, 512), generator=gen,
                                 device="cuda").to(dtype)
    if layout == "mixed":
        q, k, v = tokens(1000), rows(936), tokens(936)
    else:
        make = tokens if layout == "tokens" else rows
        q, k, v = make(1000), make(936), make(936)
    out = ha.attention_fwd(q, k, v, 512**-0.5)
    ref = _forward_yardstick(q, k, v, 512**-0.5)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.stride() == q.stride()
    _forward_limits(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tokens", "rows", "mixed"])
def test_cuda_per_head_kernel_ragged_lengths(layout):
    """Lq 200 and Lk 72, neither a multiple of the 64-row tiles, at the
    tiny VAE's head dim, in both layouts the wrapper takes, and with k and
    v in different ones ("mixed")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(2)
    tokens = lambda l: torch.randn((2, 3, 32, l), generator=gen,
                                   device="cuda").transpose(2, 3)
    rows = lambda l: torch.randn((2, 3, l, 32), generator=gen, device="cuda")
    if layout == "mixed":
        q, k, v = tokens(200), rows(72), tokens(72)
    else:
        make = tokens if layout == "tokens" else rows
        q, k, v = make(200), make(72), make(72)
    out = ha.attention_fwd(q, k, v, 32**-0.5)
    ref = _forward_yardstick(q, k, v, 32**-0.5)
    torch.cuda.synchronize()
    assert out.stride() == q.stride()
    _forward_limits(out, ref, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_per_head_backward_matches_plain(dtype):
    """The per-head backward kernel through ``multi_head_attention``'s
    gradient, against its plain version on the card at the SD VAE's shape
    and layout; its launch count and the strides of what it returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v, g = (torch.randn((2, 512, 1024), generator=gen, device="cuda")
                  .to(dtype)[:, None].transpose(2, 3) for _ in range(4))
    before = dict(ha.LAUNCHES)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(multi_head_attention(*leaves), leaves, g)
    refs = _backward_yardstick(q, k, v, g, 512**-0.5)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["attn_bwd"] == before["attn_bwd"] + 1
    assert ha.LAUNCHES["attn_fwd"] == before["attn_fwd"] + 1
    # chip_smoke.py's limits for this kernel
    max_tol, rms_tol = {torch.float32: (2e-5, 1.5e-6),
                        torch.bfloat16: (0.25, 0.015)}[dtype]
    for o, r, t in zip(grads, refs, (q, k, v)):
        assert o.dtype == dtype and o.stride() == t.stride()
        o, r = o.double(), r.double()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= max_tol * rms
        assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tokens", "rows", "mixed"])
def test_cuda_per_head_backward_ragged_lengths(layout):
    """Lq 200 and Lk 72, neither a multiple of the tiles, at the tiny VAE's
    head dim: both layouts, k and v in different ones ("mixed"), and a
    gradient that is dense in neither (made contiguous by the wrapper)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(3)
    tokens = lambda l: torch.randn((2, 3, 32, l), generator=gen,
                                   device="cuda").transpose(2, 3)
    rows = lambda l: torch.randn((2, 3, l, 32), generator=gen, device="cuda")
    if layout == "mixed":
        q, k, v = tokens(200), rows(72), tokens(72)
        g = torch.randn((2, 3, 200, 64), generator=gen,
                        device="cuda")[..., ::2]
    else:
        make = tokens if layout == "tokens" else rows
        q, k, v, g = make(200), make(72), make(72), make(200)
    outs = ha.attention_bwd(q, k, v, g, 32**-0.5)
    refs = _backward_yardstick(q, k, v, g, 32**-0.5)
    torch.cuda.synchronize()
    for o, r, t in zip(outs, refs, (q, k, v)):
        assert o.stride() == t.stride()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= 2e-5 * rms


D256 = [(8, 16, torch.float32), (2, 1000, torch.float32),
        (2, 1000, torch.bfloat16)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,dtype", D256)
def test_cuda_per_head_forward_at_head_dim_256(b, l, dtype):
    """Kernel 3 at the spec decoder's mid attention (8, 1, 16, 256) of
    ``train/stage2_decode.py`` in its token layout, and at a ragged length
    with tile edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((b, 256, l), generator=gen, device="cuda")
               .to(dtype)[:, None].transpose(2, 3) for _ in range(3))
    before = ha.LAUNCHES["attn_fwd"]
    out = multi_head_attention(q, k, v)
    ref = _forward_yardstick(q, k, v, 256**-0.5)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["attn_fwd"] == before + 1
    _forward_limits(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,l,dtype", D256)
def test_cuda_per_head_backward_at_head_dim_256(b, l, dtype):
    """Kernel 4 at the same shapes, through the attention's gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(1)
    q, k, v, g = (torch.randn((b, 256, l), generator=gen, device="cuda")
                  .to(dtype)[:, None].transpose(2, 3) for _ in range(4))
    before = ha.LAUNCHES["attn_bwd"]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(multi_head_attention(*leaves), leaves, g)
    refs = _backward_yardstick(q, k, v, g, 256**-0.5)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["attn_bwd"] == before + 1
    max_tol, rms_tol = {torch.float32: (2e-5, 1.5e-6),
                        torch.bfloat16: (0.25, 0.015)}[dtype]
    for o, r in zip(grads, refs):
        o, r = o.double(), r.double()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= max_tol * rms
        assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


# The diffusion prior's self-attention (its p_losses batch 64 and its
# sample batch 16 of 8 heads over 16 tokens, D 64), a ragged length with
# tile edges, and EncoderUNetModel's attention pool: one mean-token query
# against the 4 × 16 map's 64 tokens and itself (D 32)
PRIOR_AND_POOL = [(64, 16, 16, 64, torch.float32),
                  (2, 1000, 1000, 64, torch.float32),
                  (2, 1000, 1000, 64, torch.bfloat16),
                  (16, 1, 65, 32, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,lq,lk,d,dtype", PRIOR_AND_POOL)
def test_cuda_per_head_kernels_at_the_prior_and_pool_shapes(b, lq, lk, d,
                                                            dtype):
    """Kernels 3 and 4 over row-major (B, 8, L, D) operands, as the prior
    and the pool hand them in, against the yardsticks at chip_smoke.py's
    limits; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(lq + d)
    q, g = (torch.randn((b, 8, lq, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    k, v = (torch.randn((b, 8, lk, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    before = dict(ha.LAUNCHES)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = multi_head_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    ref = _forward_yardstick(q, k, v, d**-0.5)
    refs = _backward_yardstick(q, k, v, g, d**-0.5)
    torch.cuda.synchronize()
    assert ha.LAUNCHES["attn_fwd"] == before["attn_fwd"] + 1
    assert ha.LAUNCHES["attn_bwd"] == before["attn_bwd"] + 1
    _forward_limits(out.detach(), ref, dtype)
    max_tol, rms_tol = {torch.float32: (2e-5, 1.5e-6),
                        torch.bfloat16: (0.25, 0.015)}[dtype]
    for o, r in zip(grads, refs):
        o, r = o.double(), r.double()
        rms = float(r.square().mean().sqrt())
        assert float((o - r).abs().max()) <= max_tol * rms
        assert float((o - r).square().mean().sqrt()) <= rms_tol * rms
