"""Conditioning-stage embedders beside the video encoders
(``diff_foley_tpu/models/cond_text.py``).

- ``ClassEmbedder``: a class id → one (B, 1, embed_dim) cross-attention
  token (an ``nn.Embedding`` lookup).
- ``FrozenCLIPTextEmbedder``: the frozen CLIP text tower of
  ``transformers`` (its torch ``CLIPTextModel``), last hidden states over
  token ids. ``transformers`` is imported inside the class only, so this
  module imports on a machine without it. The tower runs no kernel of
  this package.
"""
from __future__ import annotations

import torch
import torch.nn as nn


class ClassEmbedder(nn.Module):
    """(B,) class ids → (B, 1, embed_dim)."""

    def __init__(self, embed_dim: int, n_classes: int = 1000):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, y):
        return self.embedding(y[:, None])


class FrozenCLIPTextEmbedder:
    """The frozen HF CLIP text encoder.

    With no ``config`` it loads the pretrained ``version`` and its
    tokenizer, and falls back to ``CLIPTextConfig()`` with random weights
    where that fails, as the JAX embedder does; with a ``CLIPTextConfig``
    it builds that architecture with weights drawn from ``seed``.
    ``encode_tokens`` takes token ids; ``encode`` needs the tokenizer.
    The model lives on ``device`` (None: the first CUDA device, raising
    without one; "cpu" for the CPU), in eval mode with every parameter
    frozen."""

    def __init__(self, version: str = "openai/clip-vit-large-patch14",
                 max_length: int = 77, config=None, seed: int = 0,
                 device=None):
        from transformers import CLIPTextConfig, CLIPTextModel

        from ..pipeline import resolve_device

        self.max_length = max_length
        self.tokenizer = None
        self.model = None
        if config is None:
            try:
                self.model = CLIPTextModel.from_pretrained(version)
                from transformers import CLIPTokenizer

                self.tokenizer = CLIPTokenizer.from_pretrained(version)
            except Exception:
                # no weights to be had: the architecture, random weights
                self.model, self.tokenizer = None, None
                config = CLIPTextConfig()
        if self.model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                self.model = CLIPTextModel(config)
        self.device = resolve_device(device)
        self.model.to(self.device).eval().requires_grad_(False)

    def encode_tokens(self, input_ids) -> torch.Tensor:
        """(B, L) token ids → (B, L, width) hidden states, detached."""
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=self.device)
        with torch.no_grad():
            return self.model(input_ids=ids).last_hidden_state.detach()

    def encode(self, texts) -> torch.Tensor:
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer (the pretrained files could not "
                               "be loaded); use encode_tokens")
        batch = self.tokenizer(texts, truncation=True,
                               max_length=self.max_length,
                               padding="max_length", return_tensors="np")
        return self.encode_tokens(batch["input_ids"])
