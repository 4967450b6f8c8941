"""The port's GroupNorm (``diff_foley_tpu_torch/ops/hopper_groupnorm.py``)
against the JAX package's, on the CPU.

The port runs NCHW maps, the JAX package NHWC: inputs are made with numpy
in NHWC and handed to the port transposed. JAX runs its XLA formula and
its Pallas kernels in TPU interpret mode, as tests/test_pallas_groupnorm.py
runs them; on CPU tensors the port's wrappers run their plain versions.
Tolerances: 2e-5 in fp32 (sums in other orders), 2e-2 in bf16 (one bf16
rounding of outputs up to ~5, taken at other places).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.ops import pallas_groupnorm as pg
from diff_foley_tpu.utils.precision import cast_floating
from diff_foley_tpu_torch.models.layers import GroupNorm32
from diff_foley_tpu_torch.ops import hopper_groupnorm as hg
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(out, ref_nhwc, tol, what):
    """|Δ| ≤ tol·(1 + |ref|) elementwise, the port's NCHW output against
    the JAX NHWC one."""
    out = out.float().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, np.asarray(ref_nhwc, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _inputs(seed, b, h, w, c, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(b, h, w, c)) * 2.0 + 0.5, dtype)
    gamma = jnp.asarray(rng.normal(size=(c,)) * 0.1 + 1.0, jnp.float32)
    beta = jnp.asarray(rng.normal(size=(c,)) * 0.1, jnp.float32)
    return x, gamma, beta


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# tests/test_pallas_groupnorm.py's shapes (NHWC): the UNet's level-0 and
# level-1 ResBlock norms, its deepest level, tiny widths
BLOCK_SHAPES = [(2, 16, 64, 320, "silu"), (2, 8, 32, 640, "silu"),
                (1, 2, 8, 1280, None), (2, 4, 4, 64, "silu")]


@pytest.mark.parametrize("b,h,w,c,act", BLOCK_SHAPES)
@pytest.mark.parametrize("oracle", ["xla", "pallas-block"])
def test_block_groupnorm_matches_jax(interpret_mode, oracle, b, h, w, c, act):
    x, gamma, beta = _inputs(0, b, h, w, c)
    jfn = pg._xla_group_norm if oracle == "xla" else pg._pallas_forward
    ref = jfn(x, gamma, beta, 32, 1e-5, act)
    out = hg.group_norm_block(_nchw(x), _t(gamma), _t(beta), 32, 1e-5, act)
    _close(out, ref, 2e-5, oracle)


# tests/test_pallas_groupnorm.py's streaming shapes: several chunks per slab
STREAM_SHAPES = [(2, 16, 512, 256, jnp.float32),
                 (2, 32, 512, 128, jnp.bfloat16)]


@pytest.mark.parametrize("b,h,w,c,dtype", STREAM_SHAPES)
@pytest.mark.parametrize("oracle", ["xla", "pallas-stream"])
def test_stream_groupnorm_matches_jax(interpret_mode, oracle, b, h, w, c,
                                      dtype):
    x, gamma, beta = _inputs(4, b, h, w, c, dtype)
    jfn = pg._xla_group_norm if oracle == "xla" else pg._streaming_forward
    ref = jfn(x, gamma, beta, 32, 1e-6, "silu")
    xt = _nchw(np.asarray(x, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    assert xt[0].numel() // 32 > hg.STREAM_CHUNK   # several chunks a slab
    out = hg.group_norm_stream(xt, _t(gamma), _t(beta), 32, 1e-6, "silu")
    assert out.dtype == xt.dtype
    _close(out, ref, 2e-5 if dtype == jnp.float32 else 2e-2, oracle)


def test_block_groupnorm_bf16_matches_jax(interpret_mode):
    # bf16 in and out: one rounding of the output, 2e-2
    x, gamma, beta = _inputs(1, 2, 8, 16, 64, jnp.bfloat16)
    xt = _nchw(np.asarray(x, np.float32)).to(torch.bfloat16)
    out = hg.group_norm_block(xt, _t(gamma), _t(beta), 32, 1e-5, "silu")
    assert out.dtype == torch.bfloat16
    for ref in (pg._xla_group_norm(x, gamma, beta, 32, 1e-5, "silu"),
                pg._pallas_forward(x, gamma, beta, 32, 1e-5, "silu")):
        _close(out, ref, 2e-2, "bf16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm32_module_matches_jax(dtype):
    # the module through fused_group_norm against JAX GroupNorm32 (its
    # shipped "xla" backend: GroupNorm in fp32, cast, then SiLU). bf16
    # params and activations on both sides: 2e-2. flax is imported here
    # only, so that the gpu cases of this file collect without it
    from diff_foley_tpu.models.layers import GroupNorm32 as JGroupNorm32

    x, _, _ = _inputs(2, 2, 4, 8, 64)
    jm = JGroupNorm32(act="silu")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    params = {"params": random_flax_params(shapes["params"], 3)}
    tm = GroupNorm32(64, act="silu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    xj, xt = x, _nchw(x)
    if dtype == "bfloat16":
        params, xj = cast_floating(params), x.astype(jnp.bfloat16)
        tm, xt = tm.to(torch.bfloat16), xt.to(torch.bfloat16)
    ref = jm.apply(params, xj)
    with torch.no_grad():
        out = tm(xt)
    assert out.dtype == xt.dtype
    _close(out, ref, 2e-5 if dtype == "float32" else 2e-2, dtype)


@pytest.mark.parametrize("act", ["silu", None])
def test_fused_group_norm_grad_matches_jax_vjp(act):
    # ∇ of Σ w·GN(x) w.r.t. x, γ and β: JAX's custom_vjp (the vjp of the
    # XLA formula) against FusedGroupNorm's backward; fp32, 1e-4
    x, gamma, beta = _inputs(5, 2, 4, 8, 64)
    wgt = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    loss = lambda a, g, b_: jnp.sum(
        pg.fused_group_norm(a, g, b_, 32, 1e-5, act) * wgt)
    refs = jax.grad(loss, argnums=(0, 1, 2))(x, gamma, beta)
    xt, gt, bt = (t.requires_grad_(True)
                  for t in (_nchw(x), _t(gamma), _t(beta)))
    (hg.fused_group_norm(xt, gt, bt, 32, 1e-5, act) * _nchw(wgt)).sum(
    ).backward()
    _close(xt.grad, refs[0], 1e-4, "dx")
    for name, t, r in (("dgamma", gt, refs[1]), ("dbeta", bt, refs[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("shape,itemsize,stream", [
    ((8, 320, 16, 64), 2, False),    # UNet level 0
    ((2, 512, 32, 128), 2, False),   # VAE 32×128 level: 128 KB, the limit
    ((2, 128, 128, 512), 2, True),   # VAE full resolution
    ((4, 256, 64, 256), 2, True),
    ((2, 128, 64, 256), 4, True),    # fp32 doubles the slab
])
def test_size_rule(shape, itemsize, stream):
    assert hg.uses_stream(shape, 32, itemsize) == stream


def test_wrappers_reject_what_the_kernels_do_not_take():
    meta = torch.empty(2, 64, 4, 8, device="meta")
    gamma = torch.ones(64, device="meta")
    # the checks the CUDA path runs before it launches
    with pytest.raises(ValueError, match="contiguous NCHW"):
        hg._check(meta.transpose(2, 3), 32, gamma, gamma)
    with pytest.raises(ValueError, match="do not split"):
        hg._check(meta, 24, gamma, gamma)
    with pytest.raises(ValueError, match="does not match"):
        hg._check(meta, 32, gamma[:32], gamma[:32])
    with pytest.raises(TypeError):
        hg._check(meta.half(), 32, gamma, gamma)
    with pytest.raises(ValueError, match="CPU or all on"):
        hg.group_norm_block(meta, gamma, gamma, 32, 1e-6)


def _gpu_inputs(shape, dtype, gen):
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    c = shape[1]
    gamma = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(dtype)
    return x, gamma, beta


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 320, 16, 64), (2, 128, 128, 512)])
def test_cuda_groupnorm_kernels_match_plain(shape, dtype):
    """The block kernel, or the stream pair, against the plain formula on
    the card, with the launch counts; max|Δ| and rms(Δ) against
    rms(plain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    x, gamma, beta = _gpu_inputs(shape, dtype, gen)
    before = dict(hg.LAUNCHES)
    out = hg.fused_group_norm(x, gamma, beta, 32, 1e-6, "silu")
    ref = hg.group_norm_reference(x, gamma, beta, 32, 1e-6, "silu")
    torch.cuda.synchronize()
    stream = hg.uses_stream(shape, 32, x.element_size())
    grew = {k: hg.LAUNCHES[k] - before[k] for k in before}
    assert grew == ({"gn_block": 0, "gn_stream_stats": 1, "gn_stream_apply": 1}
                    if stream else
                    {"gn_block": 1, "gn_stream_stats": 0, "gn_stream_apply": 0})
    # the streamed result folds the affine (x·a + b), so it is held to the
    # direct formula more loosely than chip_smoke.py holds each kernel
    max_tol, rms_tol = (0.15, 2e-3) if dtype == torch.bfloat16 else (2e-5, 2e-6)
    o, r = out.float(), ref.float()
    rms = float(r.square().mean().sqrt())
    assert out.dtype == dtype
    assert float((o - r).abs().max()) <= max_tol * rms
    assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 7, 9), (1, 32, 130, 131)])
def test_cuda_groupnorm_kernels_ragged_shapes(shape):
    """Odd map sizes: the block kernel on a slab that no thread count
    divides, the stream pair with a ragged last chunk (130·131 > 16384),
    each against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(1)
    x, gamma, beta = _gpu_inputs(shape, torch.float32, gen)
    n = x[0].numel() // 32
    pairs = [(hg.stream_stats(x, 32), hg.stream_stats_reference(x, 32))]
    a, b = hg.fold_stats(pairs[0][1], gamma, beta, n, 1e-6)
    pairs.append((hg.stream_apply(x, a, b, "silu"),
                  hg.stream_apply_reference(x, a, b, "silu")))
    if not hg.uses_stream(shape, 32, 4):
        pairs.append((hg.group_norm_block(x, gamma, beta, 32, 1e-6, "silu"),
                      hg.group_norm_reference(x, gamma, beta, 32, 1e-6,
                                              "silu")))
    torch.cuda.synchronize()
    for out, ref in pairs:
        rms = float(ref.square().mean().sqrt())
        assert float((out - ref).abs().max()) <= 1e-5 * rms


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,pdtype,offset", [
    ((2, 64, 7, 9), torch.bfloat16, None, 0),     # 252-byte slabs
    ((2, 96, 5, 7), torch.bfloat16, None, 0),     # cg·HW = 105, odd
    ((3, 32, 3, 5), torch.float32, None, 0),      # cg·HW = 15, odd
    ((2, 512, 32, 128), torch.bfloat16, None, 0),   # exactly 128 KB
    ((2, 256, 32, 128), torch.float32, None, 0),    # exactly 128 KB
    ((2, 512, 32, 128), torch.bfloat16, torch.float32, 0),
    ((2, 512, 32, 128), torch.bfloat16, None, 1),   # x off 16-byte alignment
])
def test_cuda_groupnorm_block_edge_slabs(shape, dtype, pdtype, offset):
    """The block kernel where its 16-byte units do not fit (a slab that is
    not a multiple of 16 bytes, odd cg·HW, an x off 16-byte alignment) and
    at exactly the 128 KB budget (a slab split over a cluster), with γ and
    β in x's type or fp32, one launch a call, against its plain version at
    chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(2)
    x, gamma, beta = _gpu_inputs(shape, dtype, gen)
    if pdtype is not None:
        gamma, beta = gamma.to(pdtype), beta.to(pdtype)
    if offset:
        flat = torch.empty(x.numel() + offset, dtype=dtype, device="cuda")
        x = flat[offset:].view(shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    assert not hg.uses_stream(shape, 32, x.element_size())
    before = hg.LAUNCHES["gn_block"]
    out = hg.group_norm_block(x, gamma, beta, 32, 1e-6, "silu")
    ref = hg.group_norm_reference(x, gamma, beta, 32, 1e-6, "silu")
    torch.cuda.synchronize()
    assert hg.LAUNCHES["gn_block"] == before + 1 and out.dtype == dtype
    max_tol, rms_tol = (0.15, 2e-4) if dtype == torch.bfloat16 else (1e-5,
                                                                     4e-7)
    o, r = out.double(), ref.double()
    rms = float(r.square().mean().sqrt())
    assert float((o - r).abs().max()) <= max_tol * rms
    assert float((o - r).square().mean().sqrt()) <= rms_tol * rms


@pytest.mark.gpu
def test_cuda_silu_division_is_fdiv_rn():
    """The block kernel's branch-free SiLU division equals __fdiv_rn bit for
    bit over every fp32 input in its range, and the range holds most of
    them (the rest go through __fdiv_rn itself)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    off, taken = hg.silu_division_check("cuda")
    assert off == 0 and taken > 2**31


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,dtype,offset", [
    ((130, 512, 32, 128), torch.float32, 0),   # 66560 rows, past 65535
    ((2, 128, 127, 511), torch.bfloat16, 0),   # hw 64897: single elements
    ((4, 128, 128, 512), torch.bfloat16, 1),   # x one element off 16 bytes
    ((2, 64, 64, 256), torch.float32, 1),
    ((2, 64, 40, 120), torch.bfloat16, 0),     # 600 units: a short tile
    ((2, 64, 8, 16), torch.bfloat16, 0),       # 16 units: 32 threads
])
def test_cuda_stream_apply_edges(shape, dtype, offset, act):
    """The apply kernel at the edges of its grid and of its 16-byte units:
    more than 65535 rows (B·C), a bf16 hw that is no multiple of 8 (the
    single-element route), x a contiguous view at a storage offset of one
    element, and rows of 16-byte units that end short of a full tile (and
    of a full block of threads); one launch a call, against its plain
    version at chip_smoke.py's apply limits (fp32 1e-6 / 1e-7 of rms,
    within the 1e-5 of the ragged shapes above; bf16 0.02 / 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator("cuda").manual_seed(3)
    b, c, h, w = shape
    flat = (torch.randn(b * c * h * w + offset, generator=gen, device="cuda")
            * 2 + 0.5).to(dtype)
    x = flat[offset:].view(shape)
    assert x.is_contiguous() and bool(x.data_ptr() % 16) == bool(offset)
    gamma = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    a, bb = hg.fold_stats(hg.stream_stats_reference(x, 32), gamma, beta,
                          c // 32 * h * w, 1e-6)
    before = hg.LAUNCHES["gn_stream_apply"]
    out = hg.stream_apply(x, a, bb, act)
    ref = hg.stream_apply_reference(x, a, bb, act)
    torch.cuda.synchronize()
    assert hg.LAUNCHES["gn_stream_apply"] == before + 1 and out.dtype == dtype
    max_tol, rms_tol = (0.02, 1e-4) if dtype == torch.bfloat16 else (1e-6,
                                                                     1e-7)
    o, r = out.double(), ref.double()
    rms = float(r.square().mean().sqrt())
    assert float((o - r).abs().max()) <= max_tol * rms
    assert float((o - r).square().mean().sqrt()) <= rms_tol * rms
