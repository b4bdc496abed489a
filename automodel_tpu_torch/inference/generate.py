"""Decoding helpers shared with the serving engine (port of `_dense_mlp` and
`_embed` from `automodel_tpu/inference/generate.py`). The batch-synchronous
`generate()` is not ported yet."""

from __future__ import annotations

from automodel_tpu_torch.models.llm.decoder import mlp_inner
from automodel_tpu_torch.ops.norms import rms_norm


def _dense_mlp(h, lp, cfg):
    x = rms_norm(h, lp["post_attn_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    mlp_out = mlp_inner(x, lp, cfg) @ lp["down_proj"]["kernel"]
    if cfg.use_post_norms:
        mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"]["scale"], cfg.rms_norm_eps, cfg.zero_centered_norm)
    return h + mlp_out


def _embed(params, cfg, ids):
    h = params["embed"]["embedding"][ids].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        h = h * cfg.embed_scale
    return h
