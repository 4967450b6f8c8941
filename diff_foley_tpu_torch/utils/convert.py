"""flax parameter trees → state dicts of this package's modules.

The port's modules carry the flax scope names, so conversion is a rename
and a transpose per leaf:

- ``kernel`` → ``weight``: Dense (in, out) → (out, in); Conv HWIO → OIHW;
  Conv3d tHWIO → OItHW; Conv1d (K, in, out) → (out, in, K), and the same
  reversal takes a ``transpose_kernel`` ConvTranspose1d's (K, out, in) to
  torch's (in, out, K), with no flip;
- a flax ``OptimizedLSTMCell`` (gate Denses ``ii/if/ig/io`` on the input,
  ``hi/hf/hg/ho`` with biases on the hidden state, gate order i, f, g, o)
  → one ``nn.LSTM`` layer: ``weight_ih_l0``, ``weight_hh_l0``,
  ``bias_ih_l0`` (the cell's one bias per gate) and a zero ``bias_hh_l0``;
- ``scale`` → ``weight`` and ``bias`` → ``bias`` (normalisations; a
  ``scale`` beside a ``shift``, the LPIPS scaling layer's, keeps its name);
- BatchNorm's ``batch_stats`` collection: ``mean`` → ``running_mean`` and
  ``var`` → ``running_var``, beside the parameters of the same scope;
- ``embedding`` → ``weight``; any other leaf (``pos_emb``, CAVP's scalar
  ``logit_scale``) keeps its name;
- the ``GroupNorm_0`` scope that ``GroupNorm32`` opens for its flax
  GroupNorm is folded into its parent.

Covers the UNet (its ``label_emb`` and ResBlock ``pos_emb`` tables too),
the classifier, every cond encoder, ``ClassEmbedder``, the CLIP text
tower of ``transformers``, the whole VAE and the other first stages, the
PatchGAN discriminator, LPIPS/LPAPS and every CAVP tower: a
Conv1d patch embedding's kernel, LayerNorm's ``scale``, and the ViT
towers' free parameters (``positional_embedding``, ``class_embedding``,
``proj``, ``pos_embedding``, the CLS tokens), which keep their names and
layouts; the 1-D audio UNet (Conv1d kernels), the diffusion prior (its
time ``Embed`` table and the free ``null_video_embeds`` and
``null_spec_embeds``) and ``EncoderUNetModel`` (the attention pool's
``pos_emb``). Load with ``strict=True``.
The same function carries gradients and updated parameters of a JAX train
step into the port's layout, so a test compares them leaf by leaf under
the state dict's names.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch

_FOLDED_SCOPES = {"GroupNorm_0"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = {"params", "batch_stats"}


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    # ascontiguousarray makes a 0-d array 1-d: keep a scalar's shape
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)


def _leaf(name: str, a) -> tuple[str, torch.Tensor]:
    t = _to_tensor(a)
    if name == "kernel":
        if t.dim() == 2:
            t = t.T
        elif t.dim() == 3:
            t = t.permute(2, 1, 0)
        elif t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        elif t.dim() == 5:
            t = t.permute(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"kernel of rank {t.dim()} has no rule")
    return name, t.contiguous()


_LSTM_GATES = ("i", "f", "g", "o")
_LSTM_SCOPES = {side + g for side in "ih" for g in _LSTM_GATES}


def _lstm_leaves(cell: Mapping) -> dict[str, torch.Tensor]:
    """A flax OptimizedLSTMCell's gate Denses → one nn.LSTM layer."""
    gate = lambda side, g, leaf: _to_tensor(cell[side + g][leaf])
    w_ih = torch.cat([gate("i", g, "kernel").T for g in _LSTM_GATES])
    w_hh = torch.cat([gate("h", g, "kernel").T for g in _LSTM_GATES])
    b = torch.cat([gate("h", g, "bias") for g in _LSTM_GATES])
    return {"weight_ih_l0": w_ih.contiguous(),
            "weight_hh_l0": w_hh.contiguous(), "bias_ih_l0": b,
            "bias_hh_l0": torch.zeros_like(b)}


def from_jax_params(tree) -> dict[str, torch.Tensor]:
    """flax variables ({"params": …}, with ``batch_stats`` where the model
    has BatchNorm) or a params tree of numpy arrays → state dict."""
    if isinstance(tree, Mapping) and tree and set(tree) <= _COLLECTIONS:
        trees = list(tree.values())
    else:
        trees = [tree]
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list[str]):
        for name, v in node.items():
            if isinstance(v, Mapping) and set(v) == _LSTM_SCOPES:
                for leaf, t in _lstm_leaves(v).items():
                    out[".".join(path + [name, leaf])] = t
            elif isinstance(v, Mapping):
                walk(v, path if name in _FOLDED_SCOPES else path + [name])
            else:
                leaf, t = _leaf(name, v)
                if not (leaf == "scale" and "shift" in node):
                    leaf = _LEAF_NAMES.get(leaf, leaf)
                key = ".".join(path + [leaf])
                if key in out:
                    raise ValueError(f"two leaves map to {key}")
                out[key] = t

    for t in trees:
        walk(t, [])
    return out



# ---- reference checkpoints → flax-layout trees ----------------------------
#
# The port's own numpy copy of the JAX package's walks
# (``diff_foley_tpu/utils/convert.py``): a reference torch state dict →
# the flax params tree the JAX modules take, which ``from_jax_params``
# then turns into this package's state dicts. Layout transforms: Conv2d
# OIHW → HWIO, Conv3d OItHW → tHWIO, Linear (O, I) → (I, O). A walk raises
# on a missing key, and ``_Mapper.check_used`` on a key it did not take
# (BatchNorm's ``num_batches_tracked`` is accepted and dropped).


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(t) -> np.ndarray:
    return _np(t).transpose(2, 3, 1, 0)


def _conv3d(t) -> np.ndarray:
    return _np(t).transpose(2, 3, 4, 1, 0)


def _dense(t) -> np.ndarray:
    return _np(t).transpose(1, 0)


def _set(tree: dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


class _Mapper:
    def __init__(self, sd: Mapping, prefix: str = ""):
        self.sd, self.prefix = sd, prefix
        self.tree: dict = {}
        self.stats: dict = {}   # BatchNorm running statistics
        self.used: set = set()

    def _get(self, torch_key: str):
        key = self.prefix + torch_key
        if key not in self.sd:
            raise KeyError(f"reference checkpoint lacks {key!r}")
        self.used.add(key)
        return self.sd[key]

    def take(self, my_path: str, torch_key: str, tf=_np) -> None:
        _set(self.tree, my_path, tf(self._get(torch_key)))

    def check_used(self, *others: "_Mapper") -> None:
        """Every key under this mapper's prefix taken by it or ``others``."""
        used = self.used.union(*(m.used for m in others))
        left = sorted(k for k in self.sd if k.startswith(self.prefix)
                      and k not in used
                      and not k.endswith(".num_batches_tracked"))
        if left:
            raise ValueError(f"{len(left)} reference keys have no place in "
                             f"the model: {left[:5]}")

    def gn(self, my: str, torch_key: str) -> None:
        # the flax GroupNorm32 wraps nn.GroupNorm as GroupNorm_0
        self.gn_flat(f"{my}/GroupNorm_0", torch_key)

    def gn_flat(self, my: str, torch_key: str) -> None:
        self.take(f"{my}/scale", f"{torch_key}.weight")
        self.take(f"{my}/bias", f"{torch_key}.bias")

    def conv(self, my: str, torch_key: str) -> None:
        self.take(f"{my}/kernel", f"{torch_key}.weight", _conv)
        self.take(f"{my}/bias", f"{torch_key}.bias")

    def dense(self, my: str, torch_key: str, bias: bool = True) -> None:
        self.take(f"{my}/kernel", f"{torch_key}.weight", _dense)
        if bias:
            self.take(f"{my}/bias", f"{torch_key}.bias")

    def dense_halves(self, my_first: str, my_second: str,
                     torch_key: str) -> None:
        """A torch Linear(2F) whose output rows stack [first; second] → two
        flax Dense(F) (GEGLU's split layout)."""
        w = _dense(self._get(f"{torch_key}.weight"))
        b = _np(self._get(f"{torch_key}.bias"))
        half = w.shape[1] // 2
        _set(self.tree, f"{my_first}/kernel", w[:, :half])
        _set(self.tree, f"{my_first}/bias", b[:half])
        _set(self.tree, f"{my_second}/kernel", w[:, half:])
        _set(self.tree, f"{my_second}/bias", b[half:])

    def bn(self, my: str, torch_key: str) -> None:
        self.gn_flat(my, torch_key)
        for src, dst in (("running_mean", "mean"), ("running_var", "var")):
            _set(self.stats, f"{my}/{dst}", _np(self._get(
                f"{torch_key}.{src}")))

    def resblock(self, my: str, torch_key: str, has_skip: bool) -> None:
        self.gn(f"{my}/in_norm", f"{torch_key}.in_layers.0")
        self.conv(f"{my}/in_conv", f"{torch_key}.in_layers.2")
        self.dense(f"{my}/emb_dense", f"{torch_key}.emb_layers.1")
        self.gn(f"{my}/out_norm", f"{torch_key}.out_layers.0")
        self.conv(f"{my}/out_conv", f"{torch_key}.out_layers.3")
        if has_skip:
            self.conv(f"{my}/skip_conv", f"{torch_key}.skip_connection")

    def spatial_transformer(self, my: str, torch_key: str,
                            depth: int) -> None:
        self.gn_flat(f"{my}/norm", f"{torch_key}.norm")
        self.conv(f"{my}/proj_in", f"{torch_key}.proj_in")
        self.transformer_blocks(f"{my}/", f"{torch_key}.", depth)
        self.conv(f"{my}/proj_out", f"{torch_key}.proj_out")

    def transformer_blocks(self, my: str, torch_key: str,
                           depth: int) -> None:
        """The BasicTransformerBlocks under the prefixes ``my`` and
        ``torch_key`` (each empty or ending in its separator)."""
        for d in range(depth):
            tb, mb = f"{torch_key}transformer_blocks.{d}", f"{my}block{d}"
            for n in (1, 2, 3):
                self.gn_flat(f"{mb}/norm{n}", f"{tb}.norm{n}")
            for a in ("attn1", "attn2"):
                for p in ("to_q", "to_k", "to_v"):
                    self.dense(f"{mb}/{a}/{p}", f"{tb}.{a}.{p}", bias=False)
                self.dense(f"{mb}/{a}/to_out", f"{tb}.{a}.to_out.0")
            self.dense_halves(f"{mb}/ff/geglu/proj_x",
                              f"{mb}/ff/geglu/proj_gate",
                              f"{tb}.ff.net.0.proj")
            self.dense(f"{mb}/ff/out", f"{tb}.ff.net.2")

    def params(self) -> dict:
        return {"params": self.tree, "batch_stats": self.stats} \
            if self.stats else {"params": self.tree}


def _unet_down_mid(m: _Mapper, cfg) -> int:
    """Time embedding, input conv, down path and middle of the UNet and the
    classifier; returns the down path's downsampling factor."""
    m.dense("time_embed/dense0", "time_embed.0")
    m.dense("time_embed/dense1", "time_embed.2")
    m.conv("in_conv", "input_blocks.0.0")
    n, ds, ch = 1, 1, cfg.model_channels
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = mult * cfg.model_channels
        for i in range(cfg.num_res_blocks):
            m.resblock(f"down_{level}_{i}_res", f"input_blocks.{n}.0",
                       has_skip=ch != out_ch)
            ch = out_ch
            if ds in cfg.attention_resolutions:
                m.spatial_transformer(f"down_{level}_{i}_attn",
                                      f"input_blocks.{n}.1",
                                      cfg.transformer_depth)
            n += 1
        if level != len(cfg.channel_mult) - 1:
            m.conv(f"down_{level}_ds/conv", f"input_blocks.{n}.0.op")
            n += 1
            ds *= 2
    m.resblock("mid_res1", "middle_block.0", has_skip=False)
    m.spatial_transformer("mid_attn", "middle_block.1", cfg.transformer_depth)
    m.resblock("mid_res2", "middle_block.2", has_skip=False)
    return ds


def convert_unet(sd: Mapping, cfg) -> dict:
    """Reference UNetModel state dict → flax params of the UNet."""
    m = _Mapper(sd)
    ds = _unet_down_mid(m, cfg)
    mc = cfg.model_channels
    skip_chs = [mc]
    for level, mult in enumerate(cfg.channel_mult):
        skip_chs += [mult * mc] * cfg.num_res_blocks
        if level != len(cfg.channel_mult) - 1:
            skip_chs.append(mult * mc)
    mo, ch = 0, cfg.channel_mult[-1] * mc
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        out_ch = mult * mc
        for i in range(cfg.num_res_blocks + 1):
            m.resblock(f"up_{level}_{i}_res", f"output_blocks.{mo}.0",
                       has_skip=(ch + skip_chs.pop()) != out_ch)
            ch, k = out_ch, 1
            if ds in cfg.attention_resolutions:
                m.spatial_transformer(f"up_{level}_{i}_attn",
                                      f"output_blocks.{mo}.1",
                                      cfg.transformer_depth)
                k = 2
            if i == cfg.num_res_blocks and level != 0:
                m.conv(f"up_{level}_us/conv", f"output_blocks.{mo}.{k}.conv")
                ds //= 2
            mo += 1
    m.gn("out_norm", "out.0")
    m.conv("out_conv", "out.2")
    m.check_used()
    return m.params()


def convert_classifier_backbone(sd: Mapping, cfg) -> dict:
    """Reference Classifier_Backbone state dict → flax params (the encoder
    half and the head)."""
    m = _Mapper(sd)
    _unet_down_mid(m, cfg)
    m.gn("out_norm", "out.0")
    m.conv("out_conv", "out.2")
    m.dense("classifier", "classifier")
    m.check_used()
    return m.params()


def _vae_resblock(m: _Mapper, my: str, torch_key: str,
                  has_skip: bool) -> None:
    m.gn_flat(f"{my}/norm1", f"{torch_key}.norm1")
    m.conv(f"{my}/conv1", f"{torch_key}.conv1")
    m.gn_flat(f"{my}/norm2", f"{torch_key}.norm2")
    m.conv(f"{my}/conv2", f"{torch_key}.conv2")
    if has_skip:
        m.conv(f"{my}/nin_shortcut", f"{torch_key}.nin_shortcut")


def _convert_vae_half(m: _Mapper, t: str, cfg) -> None:
    """The encoder (``t="encoder"``) or the decoder of AutoencoderKL."""
    m.conv(f"{t}/conv_in", f"{t}.conv_in")
    levels = list(enumerate(cfg.ch_mult))
    if t == "encoder":
        ch = cfg.ch
        for level, mult in levels:
            for i in range(cfg.num_res_blocks):
                _vae_resblock(m, f"{t}/down_{level}_block{i}",
                              f"{t}.down.{level}.block.{i}",
                              ch != cfg.ch * mult)
                ch = cfg.ch * mult
            if level != len(levels) - 1:
                m.conv(f"{t}/down_{level}_ds/conv",
                       f"{t}.down.{level}.downsample.conv")
    else:
        ch = cfg.ch * cfg.ch_mult[-1]
        for level, mult in reversed(levels):
            for i in range(cfg.num_res_blocks + 1):
                _vae_resblock(m, f"{t}/up_{level}_block{i}",
                              f"{t}.up.{level}.block.{i}",
                              ch != cfg.ch * mult)
                ch = cfg.ch * mult
            if level != 0:
                m.conv(f"{t}/up_{level}_us/conv",
                       f"{t}.up.{level}.upsample.conv")
    _vae_resblock(m, f"{t}/mid_block1", f"{t}.mid.block_1", False)
    m.gn_flat(f"{t}/mid_attn/norm", f"{t}.mid.attn_1.norm")
    for p in ("q", "k", "v", "proj_out"):
        m.conv(f"{t}/mid_attn/{p}", f"{t}.mid.attn_1.{p}")
    _vae_resblock(m, f"{t}/mid_block2", f"{t}.mid.block_2", False)
    m.gn_flat(f"{t}/norm_out", f"{t}.norm_out")
    m.conv(f"{t}/conv_out", f"{t}.conv_out")


def convert_vae(sd: Mapping, cfg) -> dict:
    """Reference AutoencoderKL state dict → flax params of the VAE."""
    m = _Mapper(sd)
    _convert_vae_half(m, "encoder", cfg)
    _convert_vae_half(m, "decoder", cfg)
    m.conv("quant_conv", "quant_conv")
    m.conv("post_quant_conv", "post_quant_conv")
    m.check_used()
    return m.params()


def convert_cond_encoder(sd: Mapping) -> dict:
    """Reference Video_Feat_Encoder_Posembed state dict → flax params."""
    m = _Mapper(sd)
    m.dense("embedder", "embedder.0")
    m.take("pos_emb", "pos_emb.weight")
    m.check_used()
    return m.params()


def convert_cond_encoder_mlp(sd: Mapping, prefix: str = "") -> dict:
    """Reference Video_Feat_Encoder (``embedder.{0,2}``) → flax params of
    ``VideoFeatEncoderMLP``."""
    m = _Mapper(sd, prefix)
    m.dense("embedder_0", "embedder.0")
    m.dense("embedder_2", "embedder.2")
    m.check_used()
    return m.params()


def convert_cond_encoder_simple(sd: Mapping, prefix: str = "") -> dict:
    """Reference Video_Feat_Encoder_simple (``embedder.0``) → flax params
    of ``VideoFeatEncoderSimple``."""
    m = _Mapper(sd, prefix)
    m.dense("embedder", "embedder.0")
    m.check_used()
    return m.params()


def convert_cond_encoder_ar(sd: Mapping, prefix: str = "",
                            depth: int = 2) -> dict:
    """Reference Video_Feat_Encoder_Posembed_AR (``embed_video_feat.0``,
    ``embed_spec_feat.0``, the two position tables, ``fusion_net.
    fusion_module.{norm,proj_in,transformer_blocks,proj_out}`` and
    ``fusion_net.proj_out.0``) → flax params of
    ``VideoFeatEncoderPosembedAR``."""
    m = _Mapper(sd, prefix)
    m.dense("embed_video_feat", "embed_video_feat.0")
    m.conv("embed_spec_feat", "embed_spec_feat.0")
    m.take("pos_emb_video", "pos_emb_video.weight")
    m.take("pos_emb_spec", "pos_emb_spec.weight")
    fm, tt = "fusion_net/fusion_module", "fusion_net.fusion_module"
    m.gn_flat(f"{fm}/norm", f"{tt}.norm")
    m.dense(f"{fm}/proj_in", f"{tt}.proj_in")
    m.transformer_blocks(f"{fm}/", f"{tt}.", depth)
    m.dense(f"{fm}/proj_out", f"{tt}.proj_out")
    m.dense("fusion_net/proj_out", "fusion_net.proj_out.0")
    m.check_used()
    return m.params()


def convert_clip_text(tree) -> dict[str, torch.Tensor]:
    """A flax ``CLIPTextModel`` params tree of numpy arrays (``text_model/
    {embeddings,encoder,final_layer_norm}``) → the state dict of
    ``transformers``' torch ``CLIPTextModel``: its module names are the
    flax ones, so this is ``from_jax_params``, checked for the
    ``text_model`` root."""
    tree = tree.get("params", tree)
    if set(tree) != {"text_model"}:
        raise ValueError(f"not a CLIP text params tree: roots {sorted(tree)}")
    return from_jax_params(tree)


def convert_simple_decoder(sd: Mapping, prefix: str = "") -> dict:
    """Reference SimpleDecoder (``model.{0 conv, 1-3 ResnetBlocks, 4 conv,
    5 upsample}``, ``norm_out``, ``conv_out``) → flax params."""
    m = _Mapper(sd, prefix)
    m.conv("conv0", "model.0")
    for i, my in enumerate(("res1", "res2", "res3"), start=1):
        _vae_resblock(m, my, f"model.{i}", has_skip=True)
    m.conv("conv4", "model.4")
    m.conv("upsample/conv", "model.5.conv")
    m.gn_flat("norm_out", "norm_out")
    m.conv("conv_out", "conv_out")
    m.check_used()
    return m.params()


def convert_upsample_decoder(sd: Mapping, in_channels: int, ch: int,
                             num_res_blocks: int, ch_mult=(2, 2),
                             prefix: str = "") -> dict:
    """Reference UpsampleDecoder (``res_blocks.{level}.{i}``,
    ``upsample_blocks.{level}``, ``norm_out``, ``conv_out``) → flax
    params."""
    m = _Mapper(sd, prefix)
    block_in = in_channels
    for level, mult in enumerate(ch_mult):
        for i in range(num_res_blocks + 1):
            _vae_resblock(m, f"res_{level}_{i}", f"res_blocks.{level}.{i}",
                          has_skip=block_in != ch * mult)
            block_in = ch * mult
        if level != len(ch_mult) - 1:
            m.conv(f"up_{level}/conv", f"upsample_blocks.{level}.conv")
    m.gn_flat("norm_out", "norm_out")
    m.conv("conv_out", "conv_out")
    m.check_used()
    return m.params()


def convert_latent_rescaler(sd: Mapping, depth: int = 2,
                            prefix: str = "") -> dict:
    """Reference LatentRescaler (``conv_in``, ``res_block{1,2}.{i}``,
    ``attn.{norm,q,k,v,proj_out}``, ``conv_out``) → flax params; every
    ResnetBlock is mid → mid, so none has a shortcut conv."""
    m = _Mapper(sd, prefix)
    m.conv("conv_in", "conv_in")
    for i in range(depth):
        _vae_resblock(m, f"res1_{i}", f"res_block1.{i}", has_skip=False)
    m.gn_flat("attn/norm", "attn.norm")
    for p in ("q", "k", "v", "proj_out"):
        m.conv(f"attn/{p}", f"attn.{p}")
    for i in range(depth):
        _vae_resblock(m, f"res2_{i}", f"res_block2.{i}", has_skip=False)
    m.conv("conv_out", "conv_out")
    m.check_used()
    return m.params()


def _walk_cnn14(m: _Mapper) -> None:
    """PANN Cnn14's keys: bn, conv_block{1..6}.{conv1,bn1,conv2,bn2}, fc1,
    final_project."""
    m.bn("bn0", "bn")
    for i in range(1, 7):
        for j in (1, 2):
            m.take(f"conv_block{i}/conv{j}/kernel",
                   f"conv_block{i}.conv{j}.weight", _conv)
            m.bn(f"conv_block{i}/bn{j}", f"conv_block{i}.bn{j}")
    m.dense("fc1", "fc1")
    m.dense("final_project", "final_project")


def _walk_slowonly(m: _Mapper, stage_blocks=(3, 4, 6, 3)) -> None:
    """mmaction ResNet3dSlowOnly's keys: conv1.{conv,bn},
    layer{s}.{b}.conv{1,2,3}.{conv,bn}, layer{s}.0.downsample.{conv,bn}."""

    def convmod(my: str, torch_key: str) -> None:
        m.take(f"{my}/conv/kernel", f"{torch_key}.conv.weight", _conv3d)
        m.bn(f"{my}/bn", f"{torch_key}.bn")

    convmod("conv1", "conv1")
    for s, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            for c in ("conv1", "conv2", "conv3"):
                convmod(f"layer{s}_{b}/{c}", f"layer{s}.{b}.{c}")
            if b == 0:
                convmod(f"layer{s}_{b}/downsample", f"layer{s}.{b}.downsample")


def convert_cnn14(sd: Mapping, prefix: str = "") -> dict:
    """PANN Cnn14's keys (``_walk_cnn14``) → CAVP's spec tower's flax
    params and batch_stats. Keys the walk does not read are left alone,
    as in a pretrained checkpoint's other heads."""
    m = _Mapper(sd, prefix)
    _walk_cnn14(m)
    return {"params": m.tree, "batch_stats": m.stats}


def convert_slowonly(sd: Mapping, prefix: str = "",
                     stage_blocks=(3, 4, 6, 3)) -> dict:
    """mmaction ResNet3dSlowOnly's keys (``_walk_slowonly``) → CAVP's
    video tower's flax params and batch_stats; other keys are left
    alone."""
    m = _Mapper(sd, prefix)
    _walk_slowonly(m, stage_blocks)
    return {"params": m.tree, "batch_stats": m.stats}


def merge_params(init_tree, loaded_tree, _path: str = ""):
    """strict=False checkpoint semantics (ddpm.py:191-207): the loaded
    value where its key exists and its shape matches, the initial one
    otherwise. → (merged, missing, unexpected): the "/"-joined paths of
    the initial leaves kept (absent or of another shape) and of the loaded
    keys with no place, each in walk order."""
    missing, unexpected = [], []

    def walk(init, loaded, path):
        if isinstance(init, Mapping):
            loaded = loaded if isinstance(loaded, Mapping) else {}
            out = {}
            for k, v in init.items():
                if k in loaded:
                    out[k] = walk(v, loaded[k], f"{path}/{k}")
                else:
                    missing.append(f"{path}/{k}")
                    out[k] = v
            unexpected.extend(f"{path}/{k}" for k in loaded if k not in init)
            return out
        if loaded is None or np.shape(loaded) != np.shape(init) or \
                isinstance(loaded, Mapping):
            missing.append(path)
            return init
        return loaded

    merged = walk(init_tree, loaded_tree, _path)
    return merged, missing, unexpected


def inflate_resnet50_to_slowonly(sd: Mapping, prefix: str = "",
                                 stage_blocks=(3, 4, 6, 3)) -> dict:
    """torchvision ResNet-50 (2-D) → SlowOnly-R50 (3-D) flax variables by
    mmaction's weight inflation (audio_contrastive.py:706-766): each 2-D
    kernel repeated along time to the 3-D kernel's t and divided by t;
    BatchNorm copied. Temporal sizes: the stem 1, each block's conv1 1 in
    stages 1-2 and 3 in stages 3-4, every conv2, conv3 and downsample
    1. The classifier head (``fc``) is left alone."""
    m = _Mapper(sd, prefix)

    def inflate(my: str, key: str, t: int) -> None:
        w = _np(m._get(f"{key}.weight"))   # (O, I, kh, kw)
        w3 = np.repeat(w[:, :, None], t, axis=2) / float(t)
        _set(m.tree, f"{my}/conv/kernel", w3.transpose(2, 3, 4, 1, 0))

    inflate("conv1", "conv1", 1)
    m.bn("conv1/bn", "bn1")
    conv1_t = {1: 1, 2: 1, 3: 3, 4: 3}
    for s, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            my, key = f"layer{s}_{b}", f"layer{s}.{b}"
            for j, t in ((1, conv1_t[s]), (2, 1), (3, 1)):
                inflate(f"{my}/conv{j}", f"{key}.conv{j}", t)
                m.bn(f"{my}/conv{j}/bn", f"{key}.bn{j}")
            if b == 0:
                inflate(f"{my}/downsample", f"{key}.downsample.0", 1)
                m.bn(f"{my}/downsample/bn", f"{key}.downsample.1")
    return {"params": m.tree, "batch_stats": m.stats}


def init_cavp_pretrained_towers(cavp_variables: Mapping,
                                slowonly_kinetics_sd: Mapping | None = None,
                                cnn14_pann_sd: Mapping | None = None):
    """CAVP's towers from pretrained checkpoints (model.py:557-573): a
    Kinetics-400 SlowOnly state dict (``backbone.``-prefixed keys) and a
    PANN Cnn14 one (a ``{"model": …}`` payload or the bare dict), each
    converted and merged by ``merge_params`` into CAVPModel's flax
    variables ``cavp_variables`` ({"params", "batch_stats"}, numpy).
    → (merged variables, {"video" / "spec": (missing, unexpected)} of the
    parameters); ``from_jax_params`` of the variables loads into
    ``CAVPModel`` with ``strict=True``. The input is not modified."""
    params = dict(cavp_variables["params"])
    stats = dict(cavp_variables.get("batch_stats", {}))
    report = {}
    towers = []
    if slowonly_kinetics_sd is not None:
        sd = {k.removeprefix("backbone."): v
              for k, v in slowonly_kinetics_sd.items()}
        towers.append(("video", "video_encoder", convert_slowonly(sd)))
    if cnn14_pann_sd is not None:
        towers.append(("spec", "spec_encoder", convert_cnn14(
            cnn14_pann_sd.get("model", cnn14_pann_sd))))
    for tag, name, conv in towers:
        params[name], missing, unexpected = merge_params(params[name],
                                                         conv["params"])
        stats[name], _, _ = merge_params(stats[name], conv["batch_stats"])
        report[tag] = (missing, unexpected)
    return {"params": params, "batch_stats": stats}, report


def convert_cavp(sd: Mapping, stage_blocks=(3, 4, 6, 3)) -> dict:
    """Reference CLIP_Video_Spec state dict (video_encoder.*,
    video_project_head.*, spec_encoder.*, logit_scale) → CAVPModel's flax
    variables."""
    video, spec = _Mapper(sd, "video_encoder."), _Mapper(sd, "spec_encoder.")
    _walk_slowonly(video, stage_blocks)
    _walk_cnn14(spec)
    head = _Mapper(sd)
    head.dense("video_project_head", "video_project_head")
    head.take("logit_scale", "logit_scale",
              lambda t: _np(t).reshape(()))
    head.check_used(video, spec)
    return {"params": {"video_encoder": video.tree, "spec_encoder": spec.tree,
                       **head.tree},
            "batch_stats": {"video_encoder": video.stats,
                            "spec_encoder": spec.stats}}


def _conv1d(t) -> np.ndarray:
    # torch (out, in, K) → flax (K, in, out); ConvTranspose1d's (in, out,
    # K) → flax transpose_kernel's (K, out, in) by the same reversal
    return _np(t).transpose(2, 1, 0)


def _conv1d_full(m: _Mapper, my: str, torch_key: str) -> None:
    m.take(f"{my}/kernel", f"{torch_key}.weight", _conv1d)
    m.take(f"{my}/bias", f"{torch_key}.bias")


def convert_spatial_transformer1d(sd: Mapping, prefix: str = "",
                                  depth: int = 1) -> dict:
    """Reference 1-D SpatialTransformer state dict (GroupNorm ``norm``,
    Conv1d ``proj_in``/``proj_out``, ``transformer_blocks``) → flax params
    of ``models/attention.py::SpatialTransformer1D``."""
    m = _Mapper(sd, prefix)
    m.gn_flat("norm", "norm")
    _conv1d_full(m, "proj_in", "proj_in")
    m.transformer_blocks("", "", depth)
    _conv1d_full(m, "proj_out", "proj_out")
    m.check_used()
    return m.params()


def _lstm_layer(m: _Mapper, my: str, torch_key: str, layer: int) -> None:
    """Layer ``layer`` of a torch nn.LSTM → a flax OptimizedLSTMCell (gate
    order i, f, g, o; the two torch biases summed on the h-side Denses)."""
    w_ih = _np(m._get(f"{torch_key}.weight_ih_l{layer}"))
    w_hh = _np(m._get(f"{torch_key}.weight_hh_l{layer}"))
    b = (_np(m._get(f"{torch_key}.bias_ih_l{layer}"))
         + _np(m._get(f"{torch_key}.bias_hh_l{layer}")))
    hdim = w_hh.shape[1]
    cell = f"{my}/OptimizedLSTMCell_{layer}"
    for g, name in enumerate(_LSTM_GATES):
        rows = slice(g * hdim, (g + 1) * hdim)
        _set(m.tree, f"{cell}/i{name}/kernel", w_ih[rows].T)
        _set(m.tree, f"{cell}/h{name}/kernel", w_hh[rows].T)
        _set(m.tree, f"{cell}/h{name}/bias", b[rows])


def convert_sound_vae(sd: Mapping, prefix: str = "", n_blocks: int = 4,
                      lstm_layers: int = 2) -> dict:
    """Reference Sound_AutoencoderKL state dict (``encoder.layers.{0 stem,
    2+2i blocks}.layers.{0 res, 2 down}``, ``encoder.lstm.0``,
    ``encoder.last_conv.1``; ``decoder.layers1.0``, ``decoder.lstm.0``,
    ``decoder.layers2.{1+2j}.layers.{0 res, 2 up}``,
    ``decoder.last_conv.0``) → SoundAutoencoderKL's flax variables."""
    m = _Mapper(sd, prefix)

    def conv(my, key):
        m.take(f"{my}/kernel", f"{key}.weight", _conv1d)
        m.take(f"{my}/bias", f"{key}.bias")

    def res(my, key):
        conv(f"{my}/conv1", f"{key}.layers.0")
        conv(f"{my}/conv2", f"{key}.layers.2")

    conv("encoder/stem", "encoder.layers.0")
    for i in range(n_blocks):
        blk = f"encoder.layers.{2 + 2 * i}.layers"
        res(f"encoder/block{i}_res", f"{blk}.0")
        conv(f"encoder/block{i}_down", f"{blk}.2.layers.0")
    for n in range(lstm_layers):
        _lstm_layer(m, "encoder/lstm", "encoder.lstm.0", n)
    conv("encoder/last_conv", "encoder.last_conv.1")
    conv("decoder/stem", "decoder.layers1.0")
    for n in range(lstm_layers):
        _lstm_layer(m, "decoder/lstm", "decoder.lstm.0", n)
    for j in range(n_blocks):
        blk = f"decoder.layers2.{1 + 2 * j}.layers"
        res(f"decoder/block{j}_res", f"{blk}.0")
        conv(f"decoder/block{j}_up", f"{blk}.2.layers.0")
    conv("decoder/last_conv", "decoder.last_conv.0")
    # a Lightning checkpoint also holds its loss's discriminators
    left = sorted(k for k in sd if k.startswith((prefix + "encoder.",
                                                 prefix + "decoder."))
                  and k not in m.used)
    if left:
        raise ValueError(f"{len(left)} reference keys have no place in the "
                         f"model: {left[:5]}")
    return {"params": m.tree}


# ---- the factory's other CAVP towers ------------------------------------
#
# Each walk takes a reference tower's state dict (keys under ``prefix``)
# to the flax variables of the JAX module, which ``from_jax_params`` turns
# into the port tower's state dict; the structure arguments are the
# config's (a cut tower walks its own blocks).


def _conv3d_nobias(m: _Mapper, my: str, key: str) -> None:
    m.take(f"{my}/kernel", f"{key}.weight", _conv3d)


def convert_x3d(sd: Mapping, prefix: str = "", base_blocks=(1, 2, 5, 3),
                depth_factor: float = 5.0) -> dict:
    """PySlowFast X3D (``s1.pathway0_stem.{conv_xy,conv,bn}``,
    ``s{2..5}.pathway0_res{i}.branch2.{a,b,c,*_bn,se}``, ``branch1(_bn)``
    on each stage's first block, ``head.{conv_5,conv_5_bn,lin_5,
    projection}``; ``lin_5`` is a 1×1×1 conv used as a Dense) → X3D's
    flax variables."""
    m = _Mapper(sd, prefix)
    _conv3d_nobias(m, "s1/conv_xy", "s1.pathway0_stem.conv_xy")
    _conv3d_nobias(m, "s1/conv", "s1.pathway0_stem.conv")
    m.bn("s1/norm/bn", "s1.pathway0_stem.bn")
    for stage, base_n in enumerate(base_blocks, start=2):
        for i in range(int(math.ceil(depth_factor * base_n))):
            my, res = f"s{stage}_b{i}", f"s{stage}.pathway0_res{i}"
            for c in ("a", "b", "c"):
                _conv3d_nobias(m, f"{my}/{c}", f"{res}.branch2.{c}")
                m.bn(f"{my}/{c}_bn/bn", f"{res}.branch2.{c}_bn")
            if (i + 1) % 2 == 1:   # squeeze-excitation on even indices
                for fc in ("fc1", "fc2"):
                    _conv3d_nobias(m, f"{my}/se/{fc}", f"{res}.branch2.se.{fc}")
                    m.take(f"{my}/se/{fc}/bias", f"{res}.branch2.se.{fc}.bias")
            if i == 0:
                _conv3d_nobias(m, f"{my}/branch1", f"{res}.branch1")
                m.bn(f"{my}/branch1_bn/bn", f"{res}.branch1_bn")
    _conv3d_nobias(m, "conv_5", "head.conv_5")
    m.bn("conv_5_bn/bn", "head.conv_5_bn")
    m.take("lin_5/kernel", "head.lin_5.weight",
           lambda t: _np(t).reshape(t.shape[0], t.shape[1]).T)
    m.dense("projection", "head.projection")
    m.check_used()
    return m.params()


def convert_i3d(sd: Mapping, prefix: str = "",
                stage_blocks=(3, 4, 6, 3)) -> dict:
    """PySlowFast I3D ResNet (``s1.pathway0_stem.{conv,bn}``,
    ``s{2..5}.pathway0_res{i}.branch2.*``, ``head.projection``) →
    I3DResNet's flax variables."""
    m = _Mapper(sd, prefix)
    _conv3d_nobias(m, "stem_conv", "s1.pathway0_stem.conv")
    m.bn("stem_bn/bn", "s1.pathway0_stem.bn")
    for stage, blocks in enumerate(stage_blocks, start=2):
        for i in range(blocks):
            my, res = f"s{stage}_b{i}", f"s{stage}.pathway0_res{i}"
            for c in ("a", "b", "c"):
                _conv3d_nobias(m, f"{my}/{c}", f"{res}.branch2.{c}")
                m.bn(f"{my}/{c}_bn/bn", f"{res}.branch2.{c}_bn")
            if i == 0:
                _conv3d_nobias(m, f"{my}/branch1", f"{res}.branch1")
                m.bn(f"{my}/branch1_bn/bn", f"{res}.branch1_bn")
    m.dense("projection", "head.projection")
    m.check_used()
    return m.params()


def convert_r2plus1d(sd: Mapping, prefix: str = "",
                     stage_blocks=(3, 4, 6, 3)) -> dict:
    """mmaction ResNet2Plus1d (``conv1.conv.{conv_s,bn_s,conv_t}`` and
    ``conv1.bn``, ``layer{s}.{b}.conv{1,2}`` and the downsample of each
    stage's first block past the first stage, with the same nesting,
    ``project``) → ResNet2Plus1d's flax variables."""
    m = _Mapper(sd, prefix)

    def convmod(my: str, key: str) -> None:
        _conv3d_nobias(m, f"{my}/conv/conv_s", f"{key}.conv.conv_s")
        m.bn(f"{my}/conv/bn_s", f"{key}.conv.bn_s")
        _conv3d_nobias(m, f"{my}/conv/conv_t", f"{key}.conv.conv_t")
        m.bn(f"{my}/bn", f"{key}.bn")

    convmod("conv1", "conv1")
    for s, blocks in enumerate(stage_blocks, start=1):
        for b in range(blocks):
            convmod(f"layer{s}_{b}/conv1", f"layer{s}.{b}.conv1")
            convmod(f"layer{s}_{b}/conv2", f"layer{s}.{b}.conv2")
            if b == 0 and s > 1:
                convmod(f"layer{s}_{b}/downsample", f"layer{s}.{b}.downsample")
    m.dense("project", "project")
    m.check_used()
    return m.params()


def convert_spec_resnet50(sd: Mapping, prefix: str = "",
                          stage_blocks=(3, 4, 6, 3)) -> dict:
    """The audio ResNet-50 (``conv1.{0,1}``, ``conv{2..5}_x.{i}.
    residual_function.{0,1,3,4,6,7}`` and ``shortcut.{0,1}``) →
    SpecResNet50's flax variables."""
    m = _Mapper(sd, prefix)
    m.take("stem_conv/kernel", "conv1.0.weight", _conv)
    m.bn("stem_bn", "conv1.1")
    for stage, blocks in enumerate(stage_blocks, start=2):
        for b in range(blocks):
            my, blk = f"conv{stage}_{b}", f"conv{stage}_x.{b}"
            for j, (ci, bi) in enumerate(((0, 1), (3, 4), (6, 7)), start=1):
                m.take(f"{my}/conv{j}/kernel",
                       f"{blk}.residual_function.{ci}.weight", _conv)
                m.bn(f"{my}/bn{j}", f"{blk}.residual_function.{bi}")
            if b == 0:
                m.take(f"{my}/shortcut_conv/kernel", f"{blk}.shortcut.0.weight",
                       _conv)
                m.bn(f"{my}/shortcut_bn", f"{blk}.shortcut.1")
    m.check_used()
    return m.params()


def convert_spec_vit(sd: Mapping, prefix: str = "", layers: int = 12,
                     cls_token: bool = True) -> dict:
    """Spec_VIT / Spec_VIT_mean (``conv1``, ``class_embedding``,
    ``positional_embedding``, ``ln_pre``/``ln_post``,
    ``transformer.resblocks.{i}.{ln_1,attn,ln_2,mlp}``, ``proj``) →
    SpecViT's / SpecViTMean's flax params."""
    m = _Mapper(sd, prefix)
    m.take("conv1/kernel", "conv1.weight", _conv1d)
    if cls_token:
        m.take("class_embedding", "class_embedding")
    m.take("positional_embedding", "positional_embedding")
    for ln in ("ln_pre", "ln_post"):
        m.gn_flat(ln, ln)
    for i in range(layers):
        my, blk = f"block{i}", f"transformer.resblocks.{i}"
        m.gn_flat(f"{my}/ln_1", f"{blk}.ln_1")
        m.gn_flat(f"{my}/ln_2", f"{blk}.ln_2")
        m.take(f"{my}/attn/in_proj/kernel", f"{blk}.attn.in_proj_weight",
               _dense)
        m.take(f"{my}/attn/in_proj/bias", f"{blk}.attn.in_proj_bias")
        m.dense(f"{my}/attn/out_proj", f"{blk}.attn.out_proj")
        m.dense(f"{my}/c_fc", f"{blk}.mlp.c_fc")
        m.dense(f"{my}/c_proj", f"{blk}.mlp.c_proj")
    m.take("proj", "proj")
    m.check_used()
    return m.params()


def convert_vivit(sd: Mapping, prefix: str = "", spatial_depth: int = 8,
                  temporal_depth: int = 4, temporal_cls: bool = True) -> dict:
    """ViViT / ViViT_mean (``to_patch_embedding.{1,2,3}``,
    ``pos_embedding``, the CLS tokens, ``{spatial,temporal}_transformer.
    layers.{i}.{0: norm + attention, 1: norm + feed-forward}``) →
    ViViT's / ViViTMean's flax params."""
    m = _Mapper(sd, prefix)
    m.gn_flat("patch_norm1", "to_patch_embedding.1")
    m.dense("patch_proj", "to_patch_embedding.2")
    m.gn_flat("patch_norm2", "to_patch_embedding.3")
    m.take("pos_embedding", "pos_embedding")
    m.take("spatial_cls_token", "spatial_cls_token")
    if temporal_cls:
        m.take("temporal_cls_token", "temporal_cls_token")
    for name, depth in (("spatial_transformer", spatial_depth),
                        ("temporal_transformer", temporal_depth)):
        for i in range(depth):
            layer = f"{name}.layers.{i}"
            m.gn_flat(f"{name}/attn{i}_norm", f"{layer}.0.norm")
            m.dense(f"{name}/attn{i}/to_qkv", f"{layer}.0.fn.to_qkv",
                    bias=False)
            m.dense(f"{name}/attn{i}/to_out", f"{layer}.0.fn.to_out.0")
            m.gn_flat(f"{name}/ff{i}_norm", f"{layer}.1.norm")
            m.dense(f"{name}/ff{i}_in", f"{layer}.1.fn.net.0")
            m.dense(f"{name}/ff{i}_out", f"{layer}.1.fn.net.3")
    m.check_used()
    return m.params()


def convert_cnn10(sd: Mapping, prefix: str = "") -> dict:
    """PANN Cnn10 (``bn0``, ``conv_block{1..5}.{conv1,bn1,conv2,bn2}``,
    ``fc1``, ``final_project``) → Cnn10's flax variables."""
    m = _Mapper(sd, prefix)
    m.bn("bn0", "bn0")
    for i in range(1, 6):
        for j in (1, 2):
            m.take(f"conv_block{i}/conv{j}/kernel",
                   f"conv_block{i}.conv{j}.weight", _conv)
            m.bn(f"conv_block{i}/bn{j}", f"conv_block{i}.bn{j}")
    m.dense("fc1", "fc1")
    m.dense("final_project", "final_project")
    m.check_used()
    return m.params()


# torchvision vgg16.features' conv indices, and the end index of each of
# its five slices
_VGG_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_SLICE_BOUNDS = (4, 9, 16, 23, 30)


def _convert_perceptual(sd: Mapping, prefix: str) -> dict:
    m = _Mapper(sd, prefix)
    for i, t in enumerate(_VGG_TORCH_CONV_IDX):
        s = next(k for k, bound in enumerate(_VGG_SLICE_BOUNDS, 1)
                 if t < bound)
        m.conv(f"net/conv{i}", f"net.slice{s}.{t}")
    for k in range(5):
        # the 1×1 conv head (1, C, 1, 1) → flax (1, 1, C, 1)
        m.take(f"lin{k}/kernel", f"lin{k}.model.1.weight", _conv)
    for leaf in ("shift", "scale"):
        m.take(leaf, f"scaling_layer.{leaf}", lambda t: _np(t).reshape(-1))
    m.check_used()
    return m.params()


def convert_lpips(sd: Mapping, prefix: str = "") -> dict:
    """Reference LPIPS (taming/lpips.py:54: ``scaling_layer.{shift,scale}``
    buffers, ``net.slice{1..5}.{idx}`` VGG16 convs, ``lin{0..4}.model.1``
    heads) → flax params of ``train/perceptual.py::LPIPS``."""
    return _convert_perceptual(sd, prefix)


def convert_lpaps(sd: Mapping, prefix: str = "") -> dict:
    """Reference LPAPS (adm/modules/losses/lpaps.py:21, the same layout with
    per-frequency scaling statistics) → flax params of
    ``train/perceptual.py::LPAPS``."""
    return _convert_perceptual(sd, prefix)


_LDM_PREFIXES = (("model.diffusion_model.", 0), ("first_stage_model.", 1),
                 ("cond_stage_model.", 2))


def split_ldm_state_dict(sd: Mapping) -> tuple[dict, dict, dict]:
    """A composite LatentDiffusion checkpoint → its (UNet, VAE, cond
    encoder) sub-dicts; keys under no prefix (the schedule's buffers) are
    left out."""
    parts = ({}, {}, {})
    for k, v in sd.items():
        for prefix, i in _LDM_PREFIXES:
            if k.startswith(prefix):
                parts[i][k[len(prefix):]] = v
    return parts


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint on the CPU: a ``{"state_dict": …}`` payload is
    unwrapped and a leading ``module.`` stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): v for k, v in sd.items()}
