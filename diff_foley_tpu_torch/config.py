"""Typed configs and the reference's YAML (``diff_foley_tpu/config.py``).

Self-describing training logdirs (``save_run_config``,
``load_run_config`` and ``config_from_dict``): a trainer writes
``<logdir>/config.json`` with the typed configuration it ran, and a loader
rebuilds the same model from it. The reference-format YAML half
(``load_yaml``, ``instantiate_from_config``, ``load_ldm_from_yaml``) is at
the end; PyYAML is imported only there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Callable, Dict, Optional

RUN_CONFIG = "config.json"


def config_to_dict(cfg: Any) -> Dict:
    """Frozen dataclass config → JSON-safe dict (tuples become lists)."""
    return dataclasses.asdict(cfg)


def config_from_dict(cls, d: Dict):
    """Inverse of ``config_to_dict``: rebuild ``cls`` from a JSON dict,
    recursing into dataclass-typed fields and turning JSON lists back into
    the tuples the configs hold."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v, t = d[f.name], hints.get(f.name)
        if v is None:
            kwargs[f.name] = None
            continue
        origin = typing.get_origin(t)
        if origin is typing.Union:   # Optional[T] → T
            args = [a for a in typing.get_args(t) if a is not type(None)]
            if len(args) == 1:
                t = args[0]
                origin = typing.get_origin(t)
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            v = config_from_dict(t, v)
        elif isinstance(v, list) and not (t is list or origin is list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save_run_config(logdir: str, kind: str, **sections: Any) -> str:
    """Write ``<logdir>/config.json``: ``kind`` names the trainer; each
    section is a config dataclass (serialised) or a JSON value."""
    payload: Dict[str, Any] = {"kind": kind}
    for name, val in sections.items():
        payload[name] = (config_to_dict(val)
                         if dataclasses.is_dataclass(val) else val)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, RUN_CONFIG)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def load_run_config(logdir: str, expect_kind: Optional[str] = None) -> Dict:
    """The logdir's config.json; raises unless its kind is
    ``expect_kind`` (when given)."""
    path = os.path.join(logdir, RUN_CONFIG)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found: not a training logdir")
    with open(path) as f:
        meta = json.load(f)
    if expect_kind is not None and meta.get("kind") != expect_kind:
        raise ValueError(f"{path}: kind={meta.get('kind')!r}, expected "
                         f"{expect_kind!r}")
    return meta


# ---- the reference's YAML: {target: dotted.path, params: {...}} -------------
#
# The shipped configs (``configs/*.yaml``, the reference's
# inference/config/*.yaml) name their classes by dotted path; the targets
# resolve through an explicit registry of builders onto this package's
# config dataclasses, not by import-by-string.

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(*targets: str):
    def deco(fn):
        for t in targets:
            _REGISTRY[t] = fn
        return fn

    return deco


def load_yaml(path: str) -> Dict:
    import yaml   # PyYAML: only this reader needs it

    with open(path) as f:
        return yaml.safe_load(f)


def instantiate_from_config(cfg: Dict) -> Any:
    """A ``{target, params}`` mapping → what the target's builder makes;
    ``KeyError`` on a mapping without a target or an unknown target."""
    if not isinstance(cfg, dict) or "target" not in cfg:
        raise KeyError(f"expected a {{target, params}} mapping, got {cfg!r}")
    target = cfg["target"]
    key = _resolve_key(target)
    if key is None:
        raise KeyError(f"unknown target '{target}': register a builder in "
                       "diff_foley_tpu_torch.config")
    return _REGISTRY[key](**cfg.get("params", {}))


def _resolve_key(target: str):
    if target in _REGISTRY:
        return target
    # the trailing class name matches, so diff_foley.* and adm.* paths work
    cls = target.rsplit(".", 1)[-1]
    for k in _REGISTRY:
        if k.rsplit(".", 1)[-1] == cls:
            return k
    return None


@register("diff_foley.modules.diffusionmodules.openai_unetmodel.UNetModel")
def _build_unet_cfg(**p):
    from .models.unet import UNetConfig

    return UNetConfig(
        in_channels=p.get("in_channels", 4),
        out_channels=p.get("out_channels", 4),
        model_channels=p.get("model_channels", 320),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions",
                                          (4, 2, 1))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_heads=p.get("num_heads", 8),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim", 768),
        dropout=p.get("dropout", 0.0),
        use_checkpoint=p.get("use_checkpoint", False),
    )


@register("diff_foley.modules.double_guidance.alignment_backbone"
          ".Classifier_Backbone")
def _build_classifier_cfg(**p):
    return _build_unet_cfg(**{**p, "out_channels": p.get("out_channels", 1)})


@register("diff_foley.models.autoencoder.AutoencoderKL")
def _build_vae_cfg(**p):
    from .models.vae import VAEConfig

    dd = p.get("ddconfig", {})
    if dd.get("dropout", 0.0) > 0:
        raise NotImplementedError(
            f"VAE dropout {dd['dropout']}: the port runs the shipped rate 0")
    return VAEConfig(
        in_channels=dd.get("in_channels", 3),
        out_channels=dd.get("out_ch", 3),
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        z_channels=dd.get("z_channels", 4),
        embed_dim=p.get("embed_dim", 4),
        double_z=dd.get("double_z", True),
    )


@register("diff_foley.modules.cond_stage.video_feat_encoder"
          ".Video_Feat_Encoder_Posembed")
def _build_cond_cfg(**p) -> Dict:
    return {"origin_dim": p.get("origin_dim", 512),
            "embed_dim": p.get("embed_dim", 768),
            "seq_len": p.get("seq_len", 40)}


@register("diff_foley.models.diffusion.ddpm.LatentDiffusion")
def _build_ldm(**p):
    from .diffusion.latent_diffusion import LatentDiffusion, LDMConfig

    cond = _build_cond_cfg(**p["cond_stage_config"].get("params", {}))
    return LatentDiffusion(LDMConfig(
        unet=_build_unet_cfg(**p["unet_config"].get("params", {})),
        vae=_build_vae_cfg(**p["first_stage_config"].get("params", {})),
        cond_origin_dim=cond["origin_dim"],
        cond_embed_dim=cond["embed_dim"],
        cond_seq_len=cond["seq_len"],
        timesteps=p.get("timesteps", 1000),
        linear_start=p.get("linear_start", 0.00085),
        linear_end=p.get("linear_end", 0.0120),
        scale_factor=p.get("scale_factor", 0.18215),
    ))


def load_ldm_from_yaml(path: str):
    """The reference's Stage2_LDM.yaml (or a training YAML) → its
    LatentDiffusion (torch's default initialisation)."""
    return instantiate_from_config(load_yaml(path)["model"])
