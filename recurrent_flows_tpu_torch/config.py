"""Configs of the port: its own frozen dataclasses, the structure DSL and
the production preset, with the JAX package's field names and defaults
(``recurrent_flows_tpu/config.py``, ``configs.py``), so that a config
written for one package reads the same in the other
(``config_from_dict(RFNConfig, dataclasses.asdict(jax_cfg))``).

``check_supported`` refuses, at construction, every configuration the port
cannot run as the JAX package would: TPU-only knobs raise ``ValueError``,
paths not ported yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

__all__ = ["GlowConfig", "RFNConfig", "TrainConfig", "check_supported",
           "check_glow_supported", "config_from_dict", "parse_block",
           "parse_structure", "rfn_mnist_production"]

Block = Tuple[Any, ...]  # ints and keyword strings ('pool', 'conv', 'upsample', ...)


def parse_block(spec: str) -> Block:
    """"32-32-pool" -> (32, 32, 'pool')."""
    return tuple(int(tok) if tok.isdigit() else tok for tok in spec.split("-"))


def parse_structure(specs) -> Tuple[Block, ...]:
    """Per-block DSL strings (or one space-separated string) -> blocks."""
    if isinstance(specs, str):
        specs = specs.split()
    return tuple(parse_block(s) if isinstance(s, str) else tuple(s)
                 for s in specs)


def _tuplify(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuplify(x) for x in v)
    return v


def config_from_dict(cls, d: dict):
    """Rebuild a (possibly nested) frozen config from its ``asdict()`` form;
    keys the class does not have are ignored."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name == "glow" and isinstance(v, dict):
            v = config_from_dict(GlowConfig, v)
        else:
            v = _tuplify(v)
        kwargs[f.name] = v
    return cls(**kwargs)


@dataclass(frozen=True)
class GlowConfig:
    L: int = 3
    K: int = 10
    n_bits: int = 8
    learn_prior: bool = True
    lu_decomposed: bool = True
    n_units_affine: int = 256
    n_units_prior: int = 512
    non_lin: str = "relu"  # {relu, leakyrelu}
    make_conditional: bool = True
    flow_norm: str = "actnorm"  # {actnorm, batchnorm}
    base_norm: str = "actnorm"
    batchnorm_momentum: float = 0.0
    clamp_type: str = "realnvp"  # {glow, realnvp, softclamp, none}
    split2d_act: str = "softplus"  # {softplus, exp}
    # a GlowStep's implementation: 'auto'/'conv' = the module path
    # (actnorm_invconv kernel, cuDNN convs, coupling_transform kernel);
    # 'fused' = the whole-step glowstep kernel where H·W <= 256
    coupling_impl: str = "auto"
    coupling_dtype: str | None = None  # TPU-only, refused
    coupling_norm: str = "actnorm"
    fold_weights: bool = True  # False is a TPU A/B switch, refused
    packed_layout: object = False  # TPU-only, refused
    # the K steps of a scale with H·W <= 256 in one glowchain launch:
    # 'off' never, 'sample' the reverse direction, 'all' both directions
    chain_impl: str = "off"
    dual_stream: bool = False  # TPU-only, refused


_DEFAULT_EXTRACTOR = (
    (8, 8, "pool", 16),
    (16, 16, "pool", 32),
    (32, 32, "pool", 64),
    (64, "pool", 128),
    (128, "pool", 256),
)
_DEFAULT_UPSCALER = (
    (256, 128),
    ("upsample", 128, 128),
    ("upsample", 64, 64),
    ("upsample", 32, 32),
    ("upsample", 16, 16),
)


@dataclass(frozen=True)
class RFNConfig:
    x_channels: int = 1
    image_size: int = 64
    h_dim: int = 256
    z_dim: int = 5
    a_dim: int = 200
    L: int = 5
    K: int = 15
    extractor_structure: Tuple[Block, ...] = _DEFAULT_EXTRACTOR
    upscaler_structure: Tuple[Block, ...] = _DEFAULT_UPSCALER
    prior_structure: Block = (256, 64)
    encoder_structure: Block = (256, 64)
    structure_scaler: int = 2
    norm_type: str = "none"  # prior/encoder nets
    norm_type_features: str = "batchnorm"  # extractor/upscaler
    track_running_stats: bool = False
    skip_connection_flow: str = "with_skip"  # {without_skip, with_skip, only_skip}
    skip_connection_features: bool = True
    downscaler_tanh: bool = False
    upscaler_tanh: bool = False
    free_bits: float = -1.0
    enable_smoothing: bool = False
    res_q: bool = False
    D: int = 0  # number of latent overshoots (0 = off)
    overshot_w: float = 1.0
    temperature: float = 0.7
    glow: GlowConfig = GlowConfig(L=5, K=15)

    def __post_init__(self):
        # the flow's depth follows the model's L/K
        if self.glow.L != self.L or self.glow.K != self.K:
            object.__setattr__(
                self, "glow", dataclasses.replace(self.glow, L=self.L, K=self.K))
        if (len(self.extractor_structure) != self.L
                or len(self.upscaler_structure) != self.L):
            raise ValueError("extractor_structure and upscaler_structure "
                             "need one block per flow scale (L)")


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    n_frames: int = 10
    choose_data: str = "mnist"  # {mnist, kth, bair, shapes}
    digit_size: int = 32
    step_length: int = 4
    num_digits: int = 2
    n_bits: int = 8
    preprocess_range: str = "0.5"  # {0.5, 1.0, none, minmax}
    preprocess_scale: int = 255
    learning_rate: float = 1e-4
    scheduler_type: str = "plateau"  # {plateau, linear}
    patience_lr: int = 10_000_000
    factor_lr: float = 0.9999
    min_lr: float = 5e-5
    patience_es: int = 50_000_000
    beta_max: float = 1.0
    beta_min: float = 1e-7
    beta_steps: int = 12_000
    n_epochs: int = 100
    steps_per_epoch: int = 1875
    n_predictions: int = 7
    n_conditions: int = 3
    checkpoint_every: int = 1
    n_predictions_plot: int = 6
    seed: int = 0
    grad_clip: float = 0.0  # clip by global norm; 0 = off
    remat: bool = True  # recompute each timestep of the loss in the backward
    linear_start_step: int = 100_000
    linear_num_steps: int = 150_000


def rfn_mnist_production():
    """The thesis' production SM-MNIST RFN: (RFNConfig, TrainConfig)."""
    model = RFNConfig(
        x_channels=1, image_size=64, h_dim=200, z_dim=56, a_dim=200, L=5, K=10,
        extractor_structure=(
            (16, 16, "pool", 32),
            (32, "pool", 64),
            (64, "pool", 128),
            (128, "pool", 256),
            (256, "pool", 512),
        ),
        upscaler_structure=(
            (256,),
            ("upsample", 128, 128),
            ("upsample", 64, 64),
            ("upsample", 32, 32),
            ("upsample", 16, 16),
        ),
        prior_structure=(256, 256),
        encoder_structure=(256, 256),
        norm_type="none",
        norm_type_features="batchnorm",
        skip_connection_flow="without_skip",
        skip_connection_features=True,
        downscaler_tanh=False,
        upscaler_tanh=False,
        temperature=0.7,
        glow=GlowConfig(L=5, K=10, n_units_affine=256, n_units_prior=512,
                        flow_norm="actnorm", clamp_type="realnvp"),
    )
    train = TrainConfig(
        batch_size=30, n_frames=10, choose_data="mnist", digit_size=28,
        num_digits=2, step_length=4, n_bits=8, learning_rate=1e-4,
        patience_lr=50, beta_max=1.0, beta_min=1e-4, beta_steps=10_000,
    )
    return model, train


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
    if g.coupling_impl not in ("auto", "conv", "fused"):
        raise ValueError(f"unknown coupling_impl {g.coupling_impl!r}")
    if g.chain_impl not in ("off", "sample", "all"):
        raise ValueError(f"unknown chain_impl {g.chain_impl!r}")
    if g.flow_norm != "actnorm":
        raise NotImplementedError(
            f"flow_norm={g.flow_norm!r}: BatchNormFlow is not ported yet "
            "(ROADMAP.md queue 1, item 1)")
    if g.coupling_norm != "actnorm" or g.base_norm != "actnorm":
        raise NotImplementedError(
            "coupling_norm/base_norm other than 'actnorm' are not ported yet "
            "(ROADMAP.md queue 1, item 1)")
    if not g.lu_decomposed:
        raise NotImplementedError(
            "lu_decomposed=False is not ported yet (ROADMAP.md queue 1, item 1)")
    if g.clamp_type not in ("glow", "softclamp", "realnvp", "none"):
        raise ValueError(f"unknown clamp type {g.clamp_type!r}")
    if g.split2d_act not in ("softplus", "exp"):
        raise ValueError(f"unknown split2d_act {g.split2d_act!r}")


def check_supported(cfg: RFNConfig) -> None:
    """Raise on an RFNConfig the port does not run (see module docstring)."""
    check_glow_supported(cfg.glow)
    if cfg.track_running_stats:
        raise NotImplementedError(
            "track_running_stats (eval-mode batchnorm) is not ported yet "
            "(ROADMAP.md queue 1, item 2)")
    for block in cfg.extractor_structure + cfg.upscaler_structure:
        for op in block:
            if op in ("deconv", "squeeze"):
                raise NotImplementedError(
                    f"VGG op {op!r} is not ported yet; no preset uses it "
                    "(ROADMAP.md queue 1, item 5)")
