"""Inverse rendering: recover scene parameters from target images
(`loltracer_tpu/opt`)."""

from loltracer_tpu_torch.opt.inverse import (
    APPEARANCE_FIELDS,
    CKPT_VERSION,
    DEFAULT_TRAINABLE,
    GEOMETRY_FIELDS,
    FitResult,
    default_project,
    fit_scene,
    load_checkpoint,
    masked_optimizer,
    save_checkpoint,
    structure_fingerprint,
    trainable_leaves,
    trainable_mask,
)

__all__ = [
    "APPEARANCE_FIELDS",
    "CKPT_VERSION",
    "DEFAULT_TRAINABLE",
    "GEOMETRY_FIELDS",
    "FitResult",
    "default_project",
    "fit_scene",
    "load_checkpoint",
    "masked_optimizer",
    "save_checkpoint",
    "structure_fingerprint",
    "trainable_leaves",
    "trainable_mask",
]
