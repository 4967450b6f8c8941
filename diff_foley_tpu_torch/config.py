"""Self-describing training logdirs (``diff_foley_tpu/config.py``,
``save_run_config``, ``load_run_config`` and ``config_from_dict``): a
trainer writes ``<logdir>/config.json`` with the typed configuration it
ran, and a loader rebuilds the same model from it. The reference's YAML
loading is not ported (ROADMAP §1, the long tail).
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, Optional

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
