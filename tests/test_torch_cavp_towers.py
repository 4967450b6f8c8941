"""The port's other CAVP towers against the JAX package's, on the CPU.

- Each tower module (X3D, I3D, R(2+1)D, ViViT and ViViT-mean; CNN10, the
  spec ResNet-50, Spec-ViT and Spec-ViT-mean) at tiny widths through its
  own config fields (CNN10, whose JAX module has none, at its published
  widths on a short spec), seeded random weights and positive BatchNorm
  statistics carried over with ``from_jax_params``, in eval mode: within
  1e-4 of max(1, max|ref|).
- The factory, per tower pair of ``chip_smoke.py``'s four (every tower
  once): ``encode_video`` and ``encode_spec`` (per step raw, pooled and
  normalised), the contrastive forward and ``forward_temporal``, the JAX
  factory's towers cut by replacing its config classes and spec-tower
  classes with tiny ones while it sets up, the port's by
  ``CAVPConfig.video_tower`` / ``spec_tower``.
- The published widths: every leaf's name and shape against the JAX
  factory's init, on the ``meta`` device; a compute dtype on another
  tower refused, as in JAX.

Their training, reference walks, ``spec_augment`` and the CLI are in
``tests/test_torch_cavp_towers_train.py``.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.models import vivit as jvivit
from diff_foley_tpu.models.cavp import cavp as jcavp
from diff_foley_tpu.models.cavp import cnn14 as jcnn
from diff_foley_tpu.models.cavp import r2plus1d as jr21
from diff_foley_tpu.models.cavp import spec_towers as jspec
from diff_foley_tpu.models.cavp import x3d as jx3d
from diff_foley_tpu_torch.models import vivit as tvivit
from diff_foley_tpu_torch.models.cavp import CAVPConfig, CAVPModel
from diff_foley_tpu_torch.models.cavp import cnn14 as tcnn
from diff_foley_tpu_torch.models.cavp import r2plus1d as tr21
from diff_foley_tpu_torch.models.cavp import spec_towers as tspec
from diff_foley_tpu_torch.models.cavp import x3d as tx3d
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

# fp32 towers: max|Δ| against max(1, max|ref|)
TOL = 1e-4
# the tiny towers: every branch of each (SE and none, a projected and a
# plain shortcut, both temporal kernels of a cycled stage, an uneven
# adaptive pool, ViT attention with and without its output projection)
TINY = {
    "x3d": dict(dim_c1=4, width_factor=1.0, depth_factor=1.0, dim_c5=16,
                base_blocks=(1, 2, 1, 1), head_frames=4),
    "i3d": dict(stage_blocks=(1, 2, 1, 1), width_per_group=4,
                head_frames=4),
    "r2plus1d": dict(stage_blocks=(2, 1, 1, 1), base_channels=4,
                     head_frames=4),
    "vivit": dict(image_size=32, patch_size=16, frames=6, dim=32,
                  spatial_depth=2, temporal_depth=1, heads=2, mlp_dim=64,
                  dim_head=16),
    "resnet50": dict(stage_blocks=(1, 1, 1, 1)),
    "spec_vit": dict(spec_size=256, patch_size=64, width=32, layers=2,
                     heads=4, output_dim=32),
}
# the JAX factory's names to replace with tiny ones: the config classes
# it calls, and the spec towers it builds at their default configs
JAX_TINY = {
    "x3d": (jx3d, "X3DConfig", lambda c: functools.partial(c, **TINY["x3d"])),
    "i3d": (jx3d, "I3DConfig", lambda c: functools.partial(c, **TINY["i3d"])),
    "r2plus1d": (jr21, "R2Plus1dConfig",
                 lambda c: functools.partial(c, **TINY["r2plus1d"])),
    "vivit": (jvivit, "ViViTConfig",
              lambda c: functools.partial(c, **TINY["vivit"])),
    "resnet50": (jspec, "SpecResNet50", lambda c: functools.partial(
        c, cfg=jspec.SpecResNetConfig(**TINY["resnet50"]))),
    "spec_vit": (jspec, "SpecViT", lambda c: functools.partial(
        c, cfg=jspec.SpecViTConfig(**TINY["spec_vit"]))),
    "spec_vit_mean": (jspec, "SpecViTMean", lambda c: functools.partial(
        c, cfg=jspec.SpecViTConfig(**TINY["spec_vit"], cls_token=False))),
}
TINY["spec_vit_mean"] = TINY["spec_vit"]
VIDEO = (2, 6, 32, 32, 3)
SPEC = (2, 128, 256)
# the smoke's four pairs: every new tower once
PAIRS = (("x3d", "cnn10"), ("i3d", "resnet50"), ("r2plus1d", "spec_vit"),
         ("vivit", "spec_vit_mean"))


def _variables(module, *inputs, seed: int, **kw):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs), **kw))
    return {name: random_flax_params(tree, seed + i)
            for i, (name, tree) in enumerate(shapes.items())}


def _close(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    out = out.detach().double().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / max(1.0, np.abs(ref).max()))


def _data(seed: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=VIDEO).astype(np.float32),
            rng.uniform(size=SPEC).astype(np.float32))


# ---- the tower modules ---------------------------------------------------------

def _tower_cases():
    video = lambda x: (x, torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    spec_nchw = lambda x: (x[..., None], torch.from_numpy(x)[:, None])
    plain = lambda x: (x, torch.from_numpy(x))
    cnn = lambda x: (x.transpose(0, 2, 1)[..., None],
                     torch.from_numpy(x).transpose(1, 2)[:, None])
    return {
        "x3d": (lambda: jx3d.X3D(jx3d.X3DConfig(out_dim=8, **TINY["x3d"])),
                lambda: tx3d.X3D(tx3d.X3DConfig(out_dim=8, **TINY["x3d"])),
                "video", video),
        "i3d": (lambda: jx3d.I3DResNet(jx3d.I3DConfig(out_dim=8,
                                                      **TINY["i3d"])),
                lambda: tx3d.I3DResNet(tx3d.I3DConfig(out_dim=8,
                                                      **TINY["i3d"])),
                "video", video),
        "r2plus1d": (lambda: jr21.ResNet2Plus1d(jr21.R2Plus1dConfig(
            out_dim=8, **TINY["r2plus1d"])),
            lambda: tr21.ResNet2Plus1d(tr21.R2Plus1dConfig(
                out_dim=8, **TINY["r2plus1d"])), "video", video),
        "vivit": (lambda: jvivit.ViViT(jvivit.ViViTConfig(**TINY["vivit"])),
                  lambda: tvivit.ViViT(tvivit.ViViTConfig(**TINY["vivit"])),
                  "video", plain),
        # one head of the model's width: no output projection
        "vivit_mean-1head": (
            lambda: jvivit.ViViTMean(jvivit.ViViTConfig(**{
                **TINY["vivit"], "heads": 1, "dim_head": 32})),
            lambda: tvivit.ViViTMean(tvivit.ViViTConfig(**{
                **TINY["vivit"], "heads": 1, "dim_head": 32})),
            "video", plain),
        "cnn10": (lambda: jcnn.Cnn10(embed_dim=24),
                  lambda: tcnn.Cnn10(embed_dim=24), "short_spec", cnn),
        "resnet50": (lambda: jspec.SpecResNet50(jspec.SpecResNetConfig(
            **TINY["resnet50"])),
            lambda: tspec.SpecResNet50(tspec.SpecResNetConfig(
                **TINY["resnet50"])), "spec", spec_nchw),
        "spec_vit": (lambda: jspec.SpecViT(jspec.SpecViTConfig(
            **TINY["spec_vit"])),
            lambda: tspec.SpecViT(tspec.SpecViTConfig(**TINY["spec_vit"])),
            "spec", plain),
        "spec_vit_mean": (lambda: jspec.SpecViTMean(jspec.SpecViTConfig(
            **TINY["spec_vit"], cls_token=False)),
            lambda: tspec.SpecViTMean(tspec.SpecViTConfig(
                **TINY["spec_vit"], cls_token=False)), "spec", plain),
    }


@pytest.mark.parametrize("name", list(_tower_cases()))
def test_tower_matches_jax(name):
    make_j, make_t, kind, layout = _tower_cases()[name]
    video, spec = _data(70)
    x = {"video": video, "spec": spec[:1],
         "short_spec": spec[:, :, :64]}[kind]
    if name.startswith("vivit"):
        x = x[:1]
    jx, tx = layout(x)
    jm = make_j()
    variables = _variables(jm, jx, seed=71)
    ref = jax.jit(jm.apply)(variables, jx)
    tm = make_t().eval()
    tm.load_state_dict(from_jax_params(variables), strict=True)
    with torch.no_grad():
        out = tm(tx)
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        if o.dim() == 3 and name in ("x3d", "i3d", "r2plus1d"):
            assert o.shape[1] == 4    # the head's frames
        assert _close(o, r) <= TOL


def test_adaptive_avg_pool_t_matches_jax():
    x = np.random.default_rng(72).standard_normal((2, 7, 3)).astype(
        np.float32)
    for out_t in (1, 3, 4, 7, 14, 16):
        ref = jx3d.adaptive_avg_pool_t(jnp.asarray(x), out_t)
        out = tx3d.adaptive_avg_pool_t(torch.from_numpy(x), out_t)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    for args in ((12, 2.0, 1, 8), (48, 0.0625, 8, 8), (24, 2.25), (7, 0)):
        assert tx3d.round_width(*args) == jx3d.round_width(*args)
    for c_in, c_out, k in ((3, 64, (3, 7, 7)), (64, 128, (1, 1, 1)),
                           (128, 128, (3, 3, 3))):
        assert tr21.mid_channels_2plus1d(c_in, c_out, k) == \
            jr21.mid_channels_2plus1d(c_in, c_out, k)


# ---- the factory ---------------------------------------------------------------

def _port_cfg(video_arch, spec_arch, **kw):
    return CAVPConfig(video_arch=video_arch, spec_arch=spec_arch,
                      video_tower=TINY.get(video_arch),
                      spec_tower=TINY.get(spec_arch), **kw)


def _jax_model(pair, **kw):
    """The JAX factory with the other towers at the tiny widths: the
    config classes it calls, and the spec towers it builds at their
    default configs, replaced while it sets up (its towers are built in
    ``setup``, at each ``init``/``apply``)."""
    jm = jcavp.CAVPModel(jcavp.CAVPConfig(video_arch=pair[0],
                                          spec_arch=pair[1], **kw))
    patches = [(module, name, tiny(getattr(module, name)))
               for module, name, tiny in JAX_TINY.values()]

    def run(fn, *a, **k):
        with pytest.MonkeyPatch.context() as mp:
            for module, name, value in patches:
                mp.setattr(module, name, value)
            return fn(*a, **k)

    return jm, run


def _pair_inputs(pair, seed):
    video, spec = _data(seed)
    if pair[1] == "cnn10":
        spec = spec[:, :, :64]   # CNN10 at its published widths
    return video, spec


def _factory_outputs(m, video, spec, encode_video, encode_spec, forward,
                     forward_temporal):
    out = {}
    for pool, normalize in ((False, False), (True, True)):
        out[f"video/pool={pool}/norm={normalize}"] = encode_video(
            video, normalize=normalize, pool=pool)
        out[f"spec/pool={pool}/norm={normalize}"] = encode_spec(
            spec, normalize=normalize, pool=pool)
    out.update({f"forward/{k}": v for k, v in forward(video, spec).items()})
    out.update({f"temporal/{k}": v
                for k, v in forward_temporal(video, spec).items()})
    return out


@pytest.fixture(scope="module", params=PAIRS, ids=lambda p: "-".join(p))
def factory_run(request):
    """Every factory method of one tower pair (pool windows of 2 over the
    tiny towers' few steps), the JAX side in one jitted call."""
    pair = request.param
    video, spec = _pair_inputs(pair, 73)
    jm, run = _jax_model(pair, pool_kernel=2)
    variables = run(_variables, jm, video[:1], spec[:1], seed=74)
    tm = CAVPModel(_port_cfg(*pair, pool_kernel=2)).eval()
    tm.load_state_dict(from_jax_params(variables), strict=True)

    def jax_all(v, a, b):
        call = lambda name: lambda *x, **k: jm.apply(
            v, *x, method=getattr(jcavp.CAVPModel, name), **k)
        return _factory_outputs(jm, a, b, call("encode_video"),
                                call("encode_spec"), call("__call__"),
                                call("forward_temporal"))

    ref = run(jax.jit(jax_all), variables, video, spec)
    with torch.no_grad():
        out = _factory_outputs(tm, torch.from_numpy(video),
                               torch.from_numpy(spec), tm.encode_video,
                               tm.encode_spec, tm.forward,
                               tm.forward_temporal)
    return pair, ref, out


@pytest.mark.parametrize("part", ["video", "spec", "forward", "temporal"])
def test_factory_matches_jax(factory_run, part):
    _, ref, out = factory_run
    keys = [k for k in out if k.startswith(part + "/")]
    assert keys and set(out) == set(ref)
    for k in keys:
        assert _close(out[k], ref[k]) <= TOL, k


def test_factory_per_step_shapes(factory_run):
    # per frame: the 3-D towers' heads give head_frames (4), vivit each of
    # its 6 frames; per step: CNN10 64/16, the ResNet 4·truncate_sec, the
    # ViTs one a patch (256/64); pooled: windows of 2, the mean, the CLS
    pair, _, out = factory_run
    frames = {"vivit": 6}.get(pair[0], 4)
    steps = {"cnn10": 4, "resnet50": 16}.get(pair[1], 4)
    assert out["video/pool=False/norm=False"].shape == (2, frames, 512)
    assert out["spec/pool=False/norm=False"].shape == (2, steps, 512)
    pooled_v = (2, 512) if pair[0] == "vivit" else (2, frames // 2, 512)
    pooled_s = (2, 512) if pair[1].startswith("spec_vit") \
        else (2, steps // 2, 512)
    assert out["video/pool=True/norm=True"].shape == pooled_v
    assert out["spec/pool=True/norm=True"].shape == pooled_s


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "-".join(p))
def test_factory_published_widths_match_jax(pair):
    # every leaf of the published towers, name and shape, against the JAX
    # factory's init at the published input (16 frames of 224², 256 spec
    # steps), traced abstractly; the port's on the meta device
    jm = jcavp.CAVPModel(jcavp.CAVPConfig(video_arch=pair[0],
                                          spec_arch=pair[1]))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 224, 224, 3)),
        jnp.zeros((1, 128, 256))))
    with torch.device("meta"):
        tm = CAVPModel(CAVPConfig(video_arch=pair[0], spec_arch=pair[1]))
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    # the names and layouts from_jax_params gives each JAX leaf
    mapped = from_jax_params(jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.float32(0), a.shape), shapes))
    assert {k: tuple(v.shape) for k, v in mapped.items()} == got


def test_factory_refusals():
    for kw in ({"video_arch": "x3d"}, {"spec_arch": "resnet50"},
               {"video_arch": "vivit", "spec_arch": "spec_vit"}):
        with pytest.raises(ValueError, match="only supported"):
            CAVPModel(CAVPConfig(dtype="bfloat16", **kw))
        with pytest.raises(ValueError, match="only supported"):
            jcavp.CAVPModel(jcavp.CAVPConfig(dtype="bfloat16", **kw)).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 32, 3)),
                jnp.zeros((1, 128, 64)))
    # the shipped video tower takes a dtype beside CNN10, as in JAX
    CAVPModel(CAVPConfig(spec_arch="cnn10", dtype="bfloat16"))
    with pytest.raises(ValueError, match="unknown video_arch"):
        CAVPModel(CAVPConfig(video_arch="slowfast"))
