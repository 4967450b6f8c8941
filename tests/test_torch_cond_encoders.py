"""The port's other conditioning stages against the JAX package's, on the
CPU, fp32 on both sides, seeded random weights from the flax init tree's
shapes carried over with ``from_jax_params`` and loaded with
``strict=True``:

- ``VideoFeatEncoderMLP``, ``VideoFeatEncoderSimple``,
  ``TokenTransformerCond`` (with and without a context) and
  ``VideoFeatEncoderPosembedAR`` (2 heads of D 32, depth 2; its spec
  tokens h-major from the NHWC latent), outputs within 2e-5 of
  max(1, max|ref|); the AR encoder's gradient of Σ out² over both
  inputs and every parameter within 1e-4 of max(1, max|ref|) per tensor;
- their reference-checkpoint converters, exact against the JAX
  converters on seeded numpy state dicts in the reference layout, the
  trees loading into the port's modules with ``strict=True``;
- ``ClassEmbedder``, exact;
- ``FrozenCLIPTextEmbedder.encode_tokens`` against the JAX embedder at a
  tiny ``CLIPTextConfig``, the Flax weights carried over by
  ``convert_clip_text`` (within 1e-4; skipped without ``transformers``),
  and the module importing with ``transformers`` blocked.

The AR encoder at its published widths (8 heads of D 64, 1024 latent
keys) runs on the card in ``chip_smoke.py``'s run o.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import cond_encoder as jce
from diff_foley_tpu.models import cond_text as jct
from diff_foley_tpu.utils import convert as jconv
from diff_foley_tpu_torch.models import cond_encoder as tce
from diff_foley_tpu_torch.models import cond_text as tct
from diff_foley_tpu_torch.utils import convert as tconv
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

TOL, GRAD_TOL = 2e-5, 1e-4
AR = dict(hidden_dim=64, embed_dim=48, depth=2, seq_len=20, heads=2,
          dim_head=32)


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _flax(module, seed, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return random_flax_params(shapes["params"], seed=seed)


def _ref_sd(spec, seed):
    """A seeded reference-layout state dict: {key: shape} → numpy."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in spec.items()}


def _block_spec(prefix, dim, ctx_dim, inner, depth):
    """The reference keys of ``depth`` BasicTransformerBlocks."""
    spec = {}
    for d in range(depth):
        tb = f"{prefix}transformer_blocks.{d}"
        for n in (1, 2, 3):
            spec[f"{tb}.norm{n}.weight"] = spec[f"{tb}.norm{n}.bias"] = (dim,)
        for a, kv in (("attn1", dim), ("attn2", ctx_dim)):
            spec[f"{tb}.{a}.to_q.weight"] = (inner, dim)
            spec[f"{tb}.{a}.to_k.weight"] = (inner, kv)
            spec[f"{tb}.{a}.to_v.weight"] = (inner, kv)
            spec[f"{tb}.{a}.to_out.0.weight"] = (dim, inner)
            spec[f"{tb}.{a}.to_out.0.bias"] = (dim,)
        spec[f"{tb}.ff.net.0.proj.weight"] = (8 * dim, dim)
        spec[f"{tb}.ff.net.0.proj.bias"] = (8 * dim,)
        spec[f"{tb}.ff.net.2.weight"] = (dim, 4 * dim)
        spec[f"{tb}.ff.net.2.bias"] = (dim,)
    return spec


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["mlp", "simple"])
def test_plain_video_encoders_match_jax(name):
    jm = {"mlp": jce.VideoFeatEncoderMLP,
          "simple": jce.VideoFeatEncoderSimple}[name](embed_dim=48)
    tm = {"mlp": tce.VideoFeatEncoderMLP,
          "simple": tce.VideoFeatEncoderSimple}[name](32, 48)
    x = _x((2, 10, 32), 0)
    params = _flax(jm, 1, jnp.asarray(x))
    tm.load_state_dict(from_jax_params(params), strict=True)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("with_context", [False, True])
def test_token_transformer_cond_matches_jax(with_context):
    x = _x((2, 7, 64), 2)
    ctx = _x((2, 9, 40), 3) if with_context else None
    jm = jce.TokenTransformerCond(heads=2, dim_head=32, depth=2)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = _flax(jm, 4, jnp.asarray(x), jctx)
    tm = tce.TokenTransformerCond(64, 40 if with_context else None, heads=2,
                                  dim_head=32, depth=2)
    tm.load_state_dict(from_jax_params(params), strict=True)
    ref = jm.apply({"params": params}, jnp.asarray(x), jctx)
    with torch.no_grad():
        out = tm(torch.from_numpy(x),
                 None if ctx is None else torch.from_numpy(ctx))
    _close(out.numpy(), ref)


def _ar_batch(seed):
    return {"video_feat": _x((2, 12, 24), seed),
            "spec_prev_z": _x((2, 4, 6, 4), seed + 1)}   # NHWC


def test_ar_encoder_forward_and_gradients_match_jax():
    jm = jce.VideoFeatEncoderPosembedAR(**AR)
    batch = _ar_batch(5)
    params = _flax(jm, 6, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tce.VideoFeatEncoderPosembedAR(origin_dim=24, spec_channels=4, **AR)
    tm.load_state_dict(from_jax_params(params), strict=True)

    def loss(p, b):
        out = jm.apply({"params": p}, b)
        return jnp.sum(out**2), out

    (_, ref), (g_p, g_b) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in batch.items()}
    out = tm(tb)
    _close(out.detach().numpy(), ref)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(out.square().sum(),
                                list(tb.values()) + list(tm.parameters()))
    for k, g in zip(tb, grads[:2]):
        _close(g.numpy(), g_b[k], GRAD_TOL)
    ref_sd = from_jax_params(jax.tree.map(np.asarray, g_p))
    assert sorted(ref_sd) == sorted(names)
    for n, g in zip(names, grads[2:]):
        _close(g.numpy(), ref_sd[n].numpy(), GRAD_TOL)


def test_ar_spec_tokens_are_h_major():
    # a latent that differs only at (h 1, w 0) moves only the fusion's
    # key at token index 1·W + 0 (seen through a context-free probe)
    tm = tce.FusionNet(8, 8, 8, depth=1, heads=2, dim_head=32)
    seen = []
    tm.fusion_module.block0.attn2.to_k.register_forward_hook(
        lambda m, a, o: seen.append(a[0].detach().clone()))
    z = torch.zeros(1, 3, 5, 8)
    z2 = z.clone()
    z2[0, 1, 0] = 1.0
    with torch.no_grad():
        tm(torch.zeros(1, 2, 8), z)
        tm(torch.zeros(1, 2, 8), z2)
    moved = (seen[1] - seen[0]).abs().sum(-1)[0]
    assert moved.nonzero().flatten().tolist() == [5]


def _ar_ref_spec(depth=2):
    h, e, o = AR["hidden_dim"], AR["embed_dim"], 24
    inner = AR["heads"] * AR["dim_head"]
    fm = "fusion_net.fusion_module."
    spec = {"embed_video_feat.0.weight": (h, o), "embed_video_feat.0.bias": (h,),
            "embed_spec_feat.0.weight": (h, 4, 1, 1),
            "embed_spec_feat.0.bias": (h,),
            "pos_emb_video.weight": (20, h), "pos_emb_spec.weight": (20, h),
            f"{fm}norm.weight": (h,), f"{fm}norm.bias": (h,),
            f"{fm}proj_in.weight": (inner, h), f"{fm}proj_in.bias": (inner,),
            f"{fm}proj_out.weight": (h, inner), f"{fm}proj_out.bias": (h,),
            "fusion_net.proj_out.0.weight": (e, h),
            "fusion_net.proj_out.0.bias": (e,)}
    spec.update(_block_spec(fm, inner, h, inner, depth))
    return spec


def test_cond_encoder_converters_match_jax():
    sd = _ref_sd({"embedder.0.weight": (48, 32), "embedder.0.bias": (48,),
                  "embedder.2.weight": (48, 48), "embedder.2.bias": (48,)}, 7)
    tree = tconv.convert_cond_encoder_mlp(sd)
    _same_tree(tree, jconv.convert_cond_encoder_mlp(sd))
    tce.VideoFeatEncoderMLP(32, 48).load_state_dict(from_jax_params(tree),
                                                    strict=True)
    sd = _ref_sd({"embedder.0.weight": (48, 32), "embedder.0.bias": (48,)}, 8)
    tree = tconv.convert_cond_encoder_simple(sd)
    _same_tree(tree, jconv.convert_cond_encoder_simple(sd))
    tce.VideoFeatEncoderSimple(32, 48).load_state_dict(
        from_jax_params(tree), strict=True)
    sd = {f"cond_stage_model.{k}": v
          for k, v in _ref_sd(_ar_ref_spec(), 9).items()}
    tree = tconv.convert_cond_encoder_ar(sd, prefix="cond_stage_model.")
    _same_tree(tree, jconv.convert_cond_encoder_ar(
        sd, prefix="cond_stage_model.", depth=2))
    tm = tce.VideoFeatEncoderPosembedAR(origin_dim=24, spec_channels=4, **AR)
    tm.load_state_dict(from_jax_params(tree), strict=True)
    # the converted weights run as the JAX module does
    batch = _ar_batch(10)
    ref = jce.VideoFeatEncoderPosembedAR(**AR).apply(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    _close(out.numpy(), ref)


def test_converters_refuse_unplaced_keys():
    sd = _ref_sd({"embedder.0.weight": (48, 32), "embedder.0.bias": (48,),
                  "embedder.1.weight": (48, 48)}, 11)
    with pytest.raises(ValueError, match="no place"):
        tconv.convert_cond_encoder_simple(sd)


def test_class_embedder_matches_jax():
    y = np.asarray([0, 3, 9], np.int32)
    jm = jct.ClassEmbedder(embed_dim=24, n_classes=10)
    params = _flax(jm, 12, jnp.asarray(y))
    tm = tct.ClassEmbedder(24, 10)
    tm.load_state_dict(from_jax_params(params), strict=True)
    ref = jm.apply({"params": params}, jnp.asarray(y))
    with torch.no_grad():
        out = tm(torch.from_numpy(y).long())
    assert out.shape == (3, 1, 24)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cond_text_imports_without_transformers():
    code = ("import sys; sys.modules['transformers'] = None\n"
            "from diff_foley_tpu_torch.models import cond_text as m\n"
            "import torch\n"
            "assert m.ClassEmbedder(8, 4)(torch.tensor([1])).shape == "
            "(1, 1, 8)\n"
            "try:\n"
            "    m.FrozenCLIPTextEmbedder(device='cpu')\n"
            "except ImportError:\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "refused"


CLIP_CFG = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=77,
                vocab_size=1000)


def test_clip_text_embedder_encode_tokens_matches_jax():
    pytest.importorskip("transformers")
    from transformers import CLIPTextConfig

    cfg = CLIPTextConfig(**CLIP_CFG)
    jemb = jct.FrozenCLIPTextEmbedder(config=cfg, seed=3)
    temb = tct.FrozenCLIPTextEmbedder(config=cfg, seed=3, device="cpu")
    sd = tconv.convert_clip_text(jax.tree.map(np.asarray, jemb.params))
    temb.model.load_state_dict(sd, strict=True)
    ids = np.random.default_rng(13).integers(0, 1000, (2, 77)).astype(
        np.int32)
    ref = np.asarray(jemb.encode_tokens(ids))
    out = temb.encode_tokens(ids)
    assert out.shape == (2, 77, 32) and not out.requires_grad
    assert not any(p.requires_grad for p in temb.model.parameters())
    _close(out.numpy(), ref, 1e-4)
    with pytest.raises(RuntimeError, match="tokenizer"):
        temb.encode(["a dog barks"])


def test_clip_text_embedder_defaults_to_the_card():
    pytest.importorskip("transformers")
    from transformers import CLIPTextConfig

    cfg = CLIPTextConfig(**CLIP_CFG)
    if torch.cuda.is_available():
        emb = tct.FrozenCLIPTextEmbedder(config=cfg)
        assert emb.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tct.FrozenCLIPTextEmbedder(config=cfg)
    # a config builds its architecture from the seed: two equal models
    a = tct.FrozenCLIPTextEmbedder(config=cfg, seed=5, device="cpu")
    b = tct.FrozenCLIPTextEmbedder(config=cfg, seed=5, device="cpu")
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), k
