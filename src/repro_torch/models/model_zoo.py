"""Unified model API (the torch port of ``repro.models.model_zoo``): the
dense and VLM architectures behind one interface.

``build_model(cfg)`` returns a :class:`ModelAPI` with:
  * ``param_specs()``                  — P-spec tree (one source of truth)
  * ``loss(params, batch)``            — training objective
  * ``prefill(params, batch, max_len)``— prompt → (last logits, cache)
  * ``decode(params, batch, cache)``   — one token vs the cache (in place)
  * ``cache_specs(batch, max_len)``    — P-spec tree for the cache
  * ``batch_axes(shape)``              — logical axes of each input

The MoE, SSM, hybrid and audio families raise ``NotImplementedError``
(ROADMAP A17b); ``input_specs`` and ``abstract_params``, which serve the
dry-run, come with the 2-D layout (ROADMAP A17c).
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
from . import transformer

__all__ = ["ModelAPI", "build_model"]

PORTED_FAMILIES = ("dense", "vlm")


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    tp_degree: int = 16

    # -- parameters -----------------------------------------------------------
    def param_specs(self):
        return transformer.decoder_specs(self.cfg)

    # -- training --------------------------------------------------------------
    def loss(self, params, batch):
        return transformer.lm_loss(self.cfg, params, batch)

    # -- serving ----------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int):
        return transformer.decoder_cache_specs(self.cfg, batch, max_len, self.tp_degree)

    def prefill(self, params, batch, max_len: int):
        return transformer.decoder_prefill(self.cfg, params, batch, max_len, self.tp_degree)

    def decode(self, params, batch, cache):
        return transformer.decoder_decode(self.cfg, params, batch, cache, self.tp_degree)

    def batch_axes(self, shape: ShapeSpec) -> dict:
        """Logical axes for each input."""
        if shape.kind in ("train", "prefill"):
            axes = {"tokens": ("batch", None)}
            if shape.kind == "train":
                axes["labels"] = ("batch", None)
            if self.cfg.frontend == "patch_embed":
                axes["vision_embeds"] = ("batch", None, None)
            return axes
        return {"tokens": ("batch", None), "cache_len": ()}


def build_model(cfg: ArchConfig, tp_degree: int = 16) -> ModelAPI:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family {transformer._A17B}")
    return ModelAPI(cfg, tp_degree)
