"""Reference-checkpoint loading (``diff_foley_tpu/utils/checkpoint.py``):
the released torch checkpoints (``ldm_epoch240.ckpt``,
``cavp_epoch66.ckpt``, ``double_guidance_classifier.ckpt``) into this
package's modules.

Each loader walks the reference keys into the flax layout
(``utils/convert.py``), turns the tree into a state dict with
``from_jax_params`` and loads it with ``strict=True``: a missing key, a
key the walk does not take, or a shape the module does not have raises.
The modules are loaded in place, on the device they are on.
"""
from __future__ import annotations

import os
from typing import Optional

import torch.nn as nn

from ..diffusion.latent_diffusion import LatentDiffusion
from ..models.cavp import CAVPConfig, CAVPModel
from ..models.cond_encoder import VideoFeatEncoderPosembed
from ..models.unet import CLASSIFIER_BACKBONE, ClassifierBackbone, UNetConfig
from ..models.vae import SD_VAE, AutoencoderKL, VAEConfig
from .convert import (convert_cavp, convert_classifier_backbone,
                      convert_cond_encoder, convert_unet, convert_vae,
                      from_jax_params, load_torch_state_dict,
                      split_ldm_state_dict)


def _load(module: nn.Module, tree) -> nn.Module:
    module.load_state_dict(from_jax_params(tree), strict=True)
    return module


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_reference_ldm(ckpt_path: str, ldm: LatentDiffusion,
                       load_vae: bool = True) -> LatentDiffusion:
    """A released LatentDiffusion checkpoint into ``ldm``'s UNet, cond
    encoder and (with ``load_vae``) VAE, split on the
    ``model.diffusion_model.`` / ``first_stage_model.`` /
    ``cond_stage_model.`` prefixes."""
    unet_sd, vae_sd, cond_sd = split_ldm_state_dict(
        load_torch_state_dict(ckpt_path))
    _load(ldm.unet, convert_unet(unet_sd, ldm.cfg.unet))
    _load(ldm.cond, convert_cond_encoder(cond_sd))
    if load_vae:
        if not vae_sd:
            raise ValueError(
                f"{ckpt_path} holds no first_stage_model.* (VAE) keys: not "
                "a full LatentDiffusion checkpoint; pass load_vae=False if "
                "the VAE comes from elsewhere")
        _load(ldm.vae, convert_vae(vae_sd, ldm.cfg.vae))
    return ldm


def load_vae_checkpoint(ckpt_path: str, vae: AutoencoderKL) -> AutoencoderKL:
    """The VAE from a composite LDM checkpoint (``first_stage_model.*``) or
    a bare AutoencoderKL state dict (``encoder.*`` / ``decoder.*``)."""
    sd = load_torch_state_dict(ckpt_path)
    _, vae_sd, _ = split_ldm_state_dict(sd)
    if not vae_sd:
        if not any(k.startswith("encoder.") for k in sd):
            raise ValueError(f"{ckpt_path} has neither first_stage_model.* "
                             "nor bare encoder.* VAE keys")
        vae_sd = sd
    return _load(vae, convert_vae(vae_sd, vae.cfg))


def load_reference_cavp(ckpt_path: str,
                        cavp: Optional[CAVPModel] = None) -> CAVPModel:
    """A released CAVP checkpoint into ``cavp`` (the shipped towers when
    None)."""
    cavp = cavp or CAVPModel(CAVPConfig())
    blocks = cavp.cfg.video_stage_blocks or (3, 4, 6, 3)
    return _load(cavp, convert_cavp(load_torch_state_dict(ckpt_path),
                                    blocks))


def load_reference_classifier(ckpt_path: str,
                              cfg: UNetConfig = CLASSIFIER_BACKBONE,
                              vae_cfg: VAEConfig = SD_VAE) -> dict:
    """A released alignment-classifier checkpoint → {"backbone":
    ClassifierBackbone, "cond": its VideoFeatEncoderPosembed, and "vae":
    the VAE where the checkpoint carries one}, on the CPU. ``model.``
    is the backbone, ``cond_model.`` the cond encoder,
    ``first_stage_model.`` the VAE. Guidance uses only the backbone: it
    sees the raw CAVP features."""
    sd = load_torch_state_dict(ckpt_path)
    out = {"backbone": _load(ClassifierBackbone(cfg),
                             convert_classifier_backbone(_sub(sd, "model."),
                                                         cfg))}
    cond_tree = convert_cond_encoder(_sub(sd, "cond_model."))
    origin, embed = cond_tree["params"]["embedder"]["kernel"].shape
    seq_len = cond_tree["params"]["pos_emb"].shape[0]
    out["cond"] = _load(VideoFeatEncoderPosembed(origin, embed, seq_len),
                        cond_tree)
    vae_sd = _sub(sd, "first_stage_model.")
    if vae_sd:
        out["vae"] = _load(AutoencoderKL(vae_cfg), convert_vae(vae_sd,
                                                              vae_cfg))
    return out


def is_native_logdir(path) -> bool:
    """True for a training logdir of the JAX package (config.json beside
    its orbax checkpoints): the port has no loader for those yet."""
    return bool(path) and os.path.isdir(path) and os.path.exists(
        os.path.join(path, "config.json"))
