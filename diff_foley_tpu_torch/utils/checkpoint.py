"""Checkpoints (``diff_foley_tpu/utils/checkpoint.py``).

Reference checkpoints: the released torch files (``ldm_epoch240.ckpt``,
``cavp_epoch66.ckpt``, ``double_guidance_classifier.ckpt``) into this
package's modules. Each loader walks the reference keys into the flax
layout (``utils/convert.py``), turns the tree into a state dict with
``from_jax_params`` and loads it with ``strict=True``: a missing key, a
key the walk does not take, or a shape the module does not have raises.
The modules are loaded in place, on the device they are on.

The port's training logdirs: ``config.json`` (``config.save_run_config``)
beside ``ckpt/step_<n>.pt`` files, each written with ``torch.save`` to a
temporary name and renamed into place. ``load_native_vae`` reads a
``cli.train_vae`` logdir, ``load_native_ldm`` a ``cli.train_stage2``
one and ``load_native_classifier`` a ``cli.train_classifier`` one (both
also hold their frozen first stage under ``vae/``), ``load_native_cavp``
a ``cli.train_cavp`` one (parameters and BatchNorm statistics),
``load_native_sound_vae`` a ``cli.train_sound_vae`` one. The JAX
package's logdirs hold orbax checkpoints, which the port does not read
(that would need orbax; ROADMAP §1).
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch
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


def latest_checkpoint(ckpt_dir: str):
    """(step, path) of the newest ``step_<n>.pt``, or None."""
    found = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = re.fullmatch(r"step_(\d+)\.pt", name)
            if m:
                found.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return max(found) if found else None


def save_checkpoint(ckpt_dir: str, step: int, payload: dict,
                    keep: Optional[int] = None) -> str:
    """``torch.save`` to ``<ckpt_dir>/step_<step>.pt`` through a temporary
    name and an atomic rename; with ``keep`` only the newest ``keep``
    files stay."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.pt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep is not None:
        steps = sorted(n for n in os.listdir(ckpt_dir)
                       if re.fullmatch(r"step_\d+\.pt", n))
        steps.sort(key=lambda n: int(n[5:-3]))
        for old in steps[:-keep]:
            os.remove(os.path.join(ckpt_dir, old))
    return path


def is_port_logdir(path) -> bool:
    """True for a training logdir of this package: config.json beside
    ``ckpt/step_<n>.pt`` files."""
    return (bool(path) and os.path.exists(os.path.join(path, "config.json"))
            and latest_checkpoint(os.path.join(path, "ckpt")) is not None)


def is_native_logdir(path) -> bool:
    """True for a training logdir of the JAX package (config.json beside
    its orbax checkpoints): the port does not read orbax checkpoints."""
    return bool(path) and os.path.isdir(path) and os.path.exists(
        os.path.join(path, "config.json")) and not is_port_logdir(path)


def _newest(logdir: str, sub: str) -> dict:
    found = latest_checkpoint(os.path.join(logdir, sub))
    if found is None:
        raise FileNotFoundError(f"no step_<n>.pt under {logdir}/{sub}")
    return torch.load(found[1], map_location="cpu")


def load_native_vae(logdir: str,
                    expect_cfg: Optional[VAEConfig] = None) -> AutoencoderKL:
    """A ``cli.train_vae`` logdir → its ``AutoencoderKL`` with the newest
    checkpoint's weights, on the CPU. With ``expect_cfg`` the logdir's
    config must be that one."""
    from ..config import config_from_dict, load_run_config

    cfg = config_from_dict(VAEConfig, load_run_config(logdir, "vae")["model"])
    if expect_cfg is not None and cfg != expect_cfg:
        raise ValueError(f"{logdir} holds a VAE of {cfg}, expected "
                         f"{expect_cfg}")
    vae = AutoencoderKL(cfg)
    vae.load_state_dict(_newest(logdir, "ckpt")["vae"], strict=True)
    return vae


def load_native_ldm(logdir: str, prefer_ema: bool = True) -> LatentDiffusion:
    """A ``cli.train_stage2`` logdir → its ``LatentDiffusion`` on the CPU:
    the model config.json describes, the UNet and cond encoder of the
    newest checkpoint (the EMA shadow when the run trained one and
    ``prefer_ema``: the reference samples with the EMA weights), and the
    frozen first stage from ``vae/``, so the logdir alone generates."""
    from ..config import config_from_dict, load_run_config
    from ..diffusion.latent_diffusion import LDMConfig

    meta = load_run_config(logdir, "stage2_ldm")
    ldm = LatentDiffusion(config_from_dict(LDMConfig, meta["model"]))
    state = _newest(logdir, "ckpt")["state"]
    params = (state["ema"]["params"]
              if prefer_ema and state["ema"] is not None else state["params"])
    vae = _newest(logdir, "vae")["vae"]
    ldm.load_state_dict(
        {**params, **{f"vae.{k}": v for k, v in vae.items()}}, strict=True)
    return ldm


def load_native_classifier(logdir: str):
    """A ``cli.train_classifier`` logdir → (``ClassifierTrainer`` with the
    newest checkpoint's weights in ``trainer.model``, those parameters by
    name, the frozen VAE the run scored latents with (``vae/``), or None
    where the logdir holds none), on the CPU. ``trainer.model(z_t, t,
    feat)`` is the align-acc surface; ``trainer.model.backbone`` alone is what
    guidance takes when it feeds the raw CAVP features."""
    from ..config import config_from_dict, load_run_config
    from ..train.classifier import ClassifierTrainConfig, ClassifierTrainer

    meta = load_run_config(logdir, "classifier")
    trainer = ClassifierTrainer(
        backbone_cfg=config_from_dict(UNetConfig, meta["backbone"]),
        vae=AutoencoderKL(config_from_dict(VAEConfig, meta["vae"])),
        cfg=config_from_dict(ClassifierTrainConfig, meta["train"]),
        cond_seq_len=meta["cond_seq_len"])
    params = _newest(logdir, "ckpt")["state"]["params"]
    trainer.model.load_state_dict(params, strict=True)
    vae = None
    if latest_checkpoint(os.path.join(logdir, "vae")) is not None:
        trainer.vae.load_state_dict(_newest(logdir, "vae")["vae"],
                                    strict=True)
        vae = trainer.vae
    return trainer, dict(trainer.model.named_parameters()), vae


def load_native_cavp(logdir: str) -> CAVPModel:
    """A ``cli.train_cavp`` logdir → its ``CAVPModel`` with the newest
    checkpoint's parameters and BatchNorm running statistics (the towers'
    eval-mode statistics), in eval mode on the CPU."""
    from ..config import config_from_dict, load_run_config

    meta = load_run_config(logdir, "stage1_cavp")
    model = CAVPModel(config_from_dict(CAVPConfig, meta["model"]))
    state = _newest(logdir, "ckpt")["state"]
    model.load_state_dict({**state["params"], **state["batch_stats"]},
                          strict=True)
    return model.eval()


def native_cavp_ingest_size(logdir: str, default: int = 224) -> int:
    """The frame size the CAVP towers were trained at (the recorded init
    video shape): the ingest resize every user of the logdir should
    default to. Frames at a size the towers never saw run without error
    and give poorer features."""
    from ..config import load_run_config

    shape = load_run_config(logdir, "stage1_cavp").get("init_video_shape")
    return int(shape[2]) if shape else default


def load_native_sound_vae(logdir: str):
    """A ``cli.train_sound_vae`` logdir → its ``SoundAutoencoderKL`` with
    the newest checkpoint's weights, on the CPU, for encode and decode on
    16-kHz waveforms."""
    from ..config import config_from_dict, load_run_config
    from ..models.sound_vae import SoundAutoencoderKL, SoundVAEConfig

    meta = load_run_config(logdir, "sound_vae")
    vae = SoundAutoencoderKL(config_from_dict(SoundVAEConfig, meta["model"]))
    vae.load_state_dict(_newest(logdir, "ckpt")["vae"], strict=True)
    return vae
