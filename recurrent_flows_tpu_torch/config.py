"""Configs for the port: the JAX package's dataclasses, reused as they are.

``recurrent_flows_tpu.config`` and ``.configs`` are plain dataclasses and
import no JAX, so the port shares them instead of copying them.
``check_supported`` refuses, at construction, every configuration the port
cannot run as the JAX package would: TPU-only knobs raise ``ValueError``,
paths not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from recurrent_flows_tpu.config import GlowConfig, RFNConfig, TrainConfig
from recurrent_flows_tpu.configs import rfn_mnist_production

__all__ = ["GlowConfig", "RFNConfig", "TrainConfig", "check_supported",
           "check_glow_supported", "rfn_mnist_production"]


def check_glow_supported(g: GlowConfig) -> None:
    """Raise on a GlowConfig the port does not run."""
    if g.packed_layout:
        raise ValueError("GlowConfig.packed_layout is a TPU lane-tiling knob; "
                         "the port runs NHWC only")
    if g.dual_stream:
        raise ValueError("GlowConfig.dual_stream is a TPU-only scheduling knob")
    if g.coupling_dtype is not None:
        raise ValueError("GlowConfig.coupling_dtype is a TPU-only knob; the "
                         "port runs the coupling net in float32")
    if not g.fold_weights:
        raise ValueError("GlowConfig.fold_weights=False is a TPU A/B switch; "
                         "the port always folds (the same function)")
    if g.coupling_impl == "fused":
        raise NotImplementedError(
            "coupling_impl='fused' needs the glowstep kernel "
            "(ROADMAP.md queue 2, item 1)")
    if g.coupling_impl not in ("auto", "conv"):
        raise ValueError(f"unknown coupling_impl {g.coupling_impl!r}")
    if g.chain_impl == "all":
        raise NotImplementedError(
            "chain_impl='all' needs the glowchain forward on the training "
            "path (ROADMAP.md queue 2, item 3)")
    if g.chain_impl not in ("off", "sample"):
        raise ValueError(f"unknown chain_impl {g.chain_impl!r}")
    if g.flow_norm != "actnorm":
        raise NotImplementedError(
            f"flow_norm={g.flow_norm!r}: BatchNormFlow comes with the forward "
            "flow modules (ROADMAP.md queue 1, item 1)")
    if g.coupling_norm != "actnorm" or g.base_norm != "actnorm":
        raise NotImplementedError(
            "coupling_norm/base_norm other than 'actnorm' come with the "
            "forward flow modules (ROADMAP.md queue 1, item 1)")
    if not g.lu_decomposed:
        raise NotImplementedError(
            "lu_decomposed=False comes with the forward flow modules "
            "(ROADMAP.md queue 1, item 1)")
    if g.clamp_type not in ("glow", "softclamp", "realnvp", "none"):
        raise ValueError(f"unknown clamp type {g.clamp_type!r}")
    if g.split2d_act not in ("softplus", "exp"):
        raise ValueError(f"unknown split2d_act {g.split2d_act!r}")


def check_supported(cfg: RFNConfig) -> None:
    """Raise on an RFNConfig the port does not run (see module docstring)."""
    check_glow_supported(cfg.glow)
    if cfg.track_running_stats:
        raise NotImplementedError(
            "track_running_stats (eval-mode batchnorm) comes with the "
            "trainer (ROADMAP.md queue 1, item 2)")
    for block in cfg.extractor_structure + cfg.upscaler_structure:
        for op in block:
            if op in ("deconv", "squeeze"):
                raise NotImplementedError(
                    f"VGG op {op!r} is not ported yet; no preset uses it "
                    "(ROADMAP.md queue 1, item 5)")
