"""Unified model API (the torch port of ``repro.models.model_zoo``): every
assigned architecture behind one interface.

``build_model(cfg)`` returns a :class:`ModelAPI` with:
  * ``param_specs()``                  — P-spec tree (one source of truth)
  * ``loss(params, batch)``            — training objective
  * ``prefill(params, batch, max_len)``— prompt → (last logits, cache)
  * ``decode(params, batch, cache)``   — one token vs the cache (in place)
  * ``cache_specs(batch, max_len)``    — P-spec tree for the cache
  * ``batch_axes(shape)``              — logical axes of each input

The dense, MoE, VLM and RWKV6 (``ssm``) families run on
:mod:`.transformer`, the hybrid on :mod:`.hybrid`, the audio family on
:mod:`.encdec`.  ``input_specs`` and ``abstract_params``, which serve the
dry-run, come with the 2-D layout (ROADMAP A17c).
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
from . import encdec, hybrid, transformer

__all__ = ["ModelAPI", "build_model"]


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    tp_degree: int = 16

    # -- parameters -----------------------------------------------------------
    def param_specs(self):
        fam = self.cfg.family
        if fam == "hybrid":
            return hybrid.hybrid_specs(self.cfg)
        if fam == "audio":
            return encdec.encdec_specs(self.cfg)
        return transformer.decoder_specs(self.cfg)

    # -- training --------------------------------------------------------------
    def loss(self, params, batch):
        fam = self.cfg.family
        if fam == "hybrid":
            return hybrid.hybrid_loss(self.cfg, params, batch)
        if fam == "audio":
            return encdec.encdec_loss(self.cfg, params, batch)
        return transformer.lm_loss(self.cfg, params, batch)

    # -- serving ----------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        fam = self.cfg.family
        if fam == "hybrid":
            return hybrid.hybrid_cache_specs(self.cfg, batch, max_len, self.tp_degree)
        if fam == "audio":
            return encdec.encdec_cache_specs(self.cfg, batch, max_len, self.tp_degree)
        return transformer.decoder_cache_specs(self.cfg, batch, max_len, self.tp_degree)

    def prefill(self, params, batch, max_len: int):
        fam = self.cfg.family
        if fam == "hybrid":
            return hybrid.hybrid_prefill(self.cfg, params, batch, max_len, self.tp_degree)
        if fam == "audio":
            return encdec.encdec_prefill(self.cfg, params, batch, max_len, self.tp_degree)
        return transformer.decoder_prefill(self.cfg, params, batch, max_len, self.tp_degree)

    def decode(self, params, batch, cache):
        fam = self.cfg.family
        if fam == "hybrid":
            return hybrid.hybrid_decode(self.cfg, params, batch, cache, self.tp_degree)
        if fam == "audio":
            return encdec.encdec_decode(self.cfg, params, batch, cache, self.tp_degree)
        return transformer.decoder_decode(self.cfg, params, batch, cache, self.tp_degree)

    def batch_axes(self, shape: ShapeSpec) -> dict:
        """Logical axes for each input."""
        if shape.kind in ("train", "prefill"):
            axes = {"tokens": ("batch", None)}
            if shape.kind == "train":
                axes["labels"] = ("batch", None)
            if self.cfg.frontend == "patch_embed":
                axes["vision_embeds"] = ("batch", None, None)
            elif self.cfg.frontend == "audio_frames":
                axes["audio_embeds"] = ("batch", None, None)
            return axes
        return {"tokens": ("batch", None), "cache_len": ()}


def build_model(cfg: ArchConfig, tp_degree: int = 16) -> ModelAPI:
    return ModelAPI(cfg, tp_degree)
