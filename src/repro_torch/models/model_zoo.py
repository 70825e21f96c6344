"""Unified model API (the torch port of ``repro.models.model_zoo``): every
assigned architecture behind one interface.

``build_model(cfg)`` returns a :class:`ModelAPI` with:
  * ``param_specs()``                  — P-spec tree (one source of truth)
  * ``loss(params, batch)``            — training objective
  * ``prefill(params, batch, max_len)``— prompt → (last logits, cache)
  * ``decode(params, batch, cache)``   — one token vs the cache (in place)
  * ``cache_specs(batch, max_len)``    — P-spec tree for the cache
  * ``batch_axes(shape)``              — logical axes of each input
  * ``input_specs(shape)``             — ``meta`` stand-ins for the dry-run
  * ``abstract_params()``              — ``meta`` stand-ins of the parameters

The dense, MoE, VLM and RWKV6 (``ssm``) families run on
:mod:`.transformer`, the hybrid on :mod:`.hybrid`, the audio family on
:mod:`.encdec`.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeSpec
import torch

from . import encdec, hybrid, transformer
from .layers import abstract_params

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

    def abstract_params(self):
        return abstract_params(self.param_specs())

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

    # -- dry-run inputs -----------------------------------------------------------
    def input_specs(self, shape: ShapeSpec) -> dict:
        """``meta`` tensors with the shapes and dtypes of a step's inputs
        (``cache_len`` of a decode a 0-d int32)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        tok = lambda *sh: torch.empty(sh, dtype=torch.int32, device="meta")      # noqa: E731
        f32 = lambda *sh: torch.empty(sh, dtype=torch.float32, device="meta")    # noqa: E731

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": tok(b, s)}
            if shape.kind == "train":
                specs["labels"] = tok(b, s)
            if cfg.frontend == "patch_embed":
                n = cfg.num_frontend_tokens
                specs = {k: tok(b, s - n) for k in specs}
                specs["vision_embeds"] = f32(b, n, cfg.d_model)
            elif cfg.frontend == "audio_frames":
                specs["audio_embeds"] = f32(b, encdec.ENC_FRAMES, cfg.d_model)
            return specs
        # decode: one new token against a seq_len cache
        return {"tokens": tok(b, 1), "cache_len": torch.empty((), dtype=torch.int32,
                                                             device="meta")}

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
