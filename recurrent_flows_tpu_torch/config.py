"""Configs of the port: its own frozen dataclasses, the structure DSL and
the presets, with the JAX package's field names and defaults
(``recurrent_flows_tpu/config.py``, ``configs.py``), so that a config
written for one package reads the same in the other
(``config_from_dict(RFNConfig, dataclasses.asdict(jax_cfg))``).

``check_supported`` refuses, at construction, every configuration the port
cannot run as the JAX package would, for each family (RFN, SRNN, VRNN,
SVG) and for the ``GlowConfig`` of the standalone Glow models
(``models.glow_image``): TPU-only knobs and values the JAX package
rejects raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

__all__ = ["GlowConfig", "RFNConfig", "SRNNConfig", "SVGConfig", "TrainConfig",
           "VRNNConfig", "check_supported", "check_glow_supported", "config_from_dict",
           "parse_block", "parse_structure", "rfn_bair", "rfn_kth", "rfn_mnist_production",
           "srnn_mnist", "svg_mnist", "vrnn_mnist"]

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
    flow_norm: str = "actnorm"  # {actnorm, batchnorm}: the GlowStep norm
    base_norm: str = "actnorm"  # {actnorm, batchnorm, none}: the base prior's convs
    batchnorm_momentum: float = 0.0
    clamp_type: str = "realnvp"  # {glow, realnvp, softclamp, none}
    split2d_act: str = "softplus"  # {softplus, exp}
    # a GlowStep's implementation: 'auto'/'conv' = the module path
    # (actnorm_invconv kernel, cuDNN convs, coupling_transform kernel);
    # 'fused' = the whole-step glowstep kernel where H·W <= 256
    coupling_impl: str = "auto"
    coupling_dtype: str | None = None  # TPU-only, refused
    coupling_norm: str = "actnorm"  # {actnorm, batchnorm, none}: the coupling nets' convs
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
class SRNNConfig:
    x_channels: int = 1
    image_size: int = 64
    h_dim: int = 256
    z_dim: int = 32
    a_dim: int = 256
    loss_type: str = "bernoulli"  # {bernoulli, gaussian, mse, mol}
    dequantize: bool = True
    n_logistics: int = 5
    n_bits: int = 8
    preprocess_range: str = "1.0"
    enable_smoothing: bool = True
    res_q: bool = False
    D: int = 0  # number of latent overshoots
    overshot_w: float = 1.0
    norm_type: str = "batchnorm"
    track_running_stats: bool = False


@dataclass(frozen=True)
class VRNNConfig:
    x_channels: int = 1
    image_size: int = 64
    h_dim: int = 256
    z_dim: int = 32
    loss_type: str = "bernoulli"
    dequantize: bool = True
    n_logistics: int = 5
    n_bits: int = 8
    preprocess_range: str = "1.0"
    norm_type: str = "batchnorm"
    track_running_stats: bool = False


@dataclass(frozen=True)
class SVGConfig:
    x_channels: int = 1
    image_size: int = 64
    z_dim: int = 10
    c_features: int = 128  # g_dim
    h_dim: int = 256  # rnn_size
    posterior_rnn_layers: int = 1
    predictor_rnn_layers: int = 2
    prior_rnn_layers: int = 1
    loss_type: str = "mse"  # {bernoulli, mse, gaussian}
    variance: float = 1.0
    norm_type: str = "batchnorm"
    track_running_stats: bool = False


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


def rfn_kth():
    """64x64 grayscale KTH RFN at thesis scale (job-script geometry, L=4)."""
    model = RFNConfig(
        x_channels=1, image_size=64, h_dim=256, z_dim=32, a_dim=200, L=4, K=10,
        extractor_structure=(
            (32, "pool", 64),
            (64, "pool", 128),
            (128, "pool", 256),
            (256, "pool", 256),
        ),
        upscaler_structure=(
            (256, 128),
            ("upsample", 128, 128),
            ("upsample", 64, 64),
            ("upsample", 32, 32),
        ),
        prior_structure=(256, 64),
        encoder_structure=(256, 64),
        norm_type="none",
        norm_type_features="batchnorm",
        glow=GlowConfig(L=4, K=10, n_units_affine=256, n_units_prior=512),
    )
    train = TrainConfig(batch_size=32, n_frames=10, choose_data="kth",
                        learning_rate=1e-4, beta_steps=12_000)
    return model, train


def rfn_bair():
    """64x64 RGB BAIR RFN: the KTH model with 3 input channels, 12 frames."""
    model, train = rfn_kth()
    return (dataclasses.replace(model, x_channels=3),
            dataclasses.replace(train, choose_data="bair", n_frames=12))


def srnn_mnist():
    """SRNN on 64x64 gray Moving MNIST: h = a = 256, z = 32, smoothing,
    Bernoulli."""
    model = SRNNConfig(x_channels=1, image_size=64, h_dim=256, z_dim=32, a_dim=256,
                       loss_type="bernoulli", preprocess_range="1.0",
                       enable_smoothing=True)
    train = TrainConfig(batch_size=32, n_frames=10, preprocess_range="1.0",
                        learning_rate=1e-4)
    return model, train


def vrnn_mnist():
    """VRNN on 64x64 gray Moving MNIST: h = 256, z = 32, Bernoulli."""
    model = VRNNConfig(x_channels=1, image_size=64, h_dim=256, z_dim=32,
                       loss_type="bernoulli", preprocess_range="1.0")
    train = TrainConfig(batch_size=32, n_frames=10, preprocess_range="1.0",
                        learning_rate=1e-4)
    return model, train


def svg_mnist():
    """SVG-LP on 64x64 gray Moving MNIST: g = 128, rnn 256, z = 10, MSE on
    frames in [0, 1]."""
    model = SVGConfig(x_channels=1, image_size=64, z_dim=10, c_features=128, h_dim=256,
                      loss_type="mse")
    train = TrainConfig(batch_size=32, n_frames=10, preprocess_range="none",
                        learning_rate=1e-3, beta_max=1e-4, beta_min=1e-4)
    return model, train


FLOW_NORMS = ("actnorm", "batchnorm")  # the GlowStep norm (JAX GlowStep)
CONV_NORMS = ("actnorm", "batchnorm", "none")  # Conv2dNorm's norm


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
    if g.flow_norm not in FLOW_NORMS:
        raise ValueError(f"unknown flow_norm {g.flow_norm!r}; one of {FLOW_NORMS}")
    for name in ("coupling_norm", "base_norm"):
        if getattr(g, name) not in CONV_NORMS:
            raise ValueError(f"unknown {name} {getattr(g, name)!r}; one of "
                             f"{CONV_NORMS}")
    if g.clamp_type not in ("glow", "softclamp", "realnvp", "none"):
        raise ValueError(f"unknown clamp type {g.clamp_type!r}")
    if g.split2d_act not in ("softplus", "exp"):
        raise ValueError(f"unknown split2d_act {g.split2d_act!r}")


EXTRACTOR_OPS = ("pool", "conv", "squeeze")  # besides an int: a 3x3 conv
UPSCALER_OPS = ("upsample", "deconv", "squeeze")


def _check_rfn(cfg: RFNConfig) -> None:
    """The flow, and the VGG structures as the JAX modules build them: an
    extractor block holds ints and ``EXTRACTOR_OPS``, an upscaler block
    ints and ``UPSCALER_OPS``, exactly one of them in every block after the
    first (the first block's are ignored, as in JAX)."""
    check_glow_supported(cfg.glow)
    for block in cfg.extractor_structure:
        for op in block:
            if not isinstance(op, int) and op not in EXTRACTOR_OPS:
                raise ValueError(f"extractor op {op!r}: an int or one of {EXTRACTOR_OPS}")
    for l, block in enumerate(cfg.upscaler_structure):
        ups = [op for op in block if not isinstance(op, int)]
        if any(op not in UPSCALER_OPS for op in ups) or (l > 0 and len(ups) != 1):
            raise ValueError(f"upscaler block {l} {block!r}: ints and, after the first "
                             f"block, exactly one of {UPSCALER_OPS}")


NORM_TYPES = ("batchnorm", "instancenorm", "none")


def _check_common(cfg, loss_types) -> None:
    if cfg.loss_type not in loss_types:
        raise ValueError(f"undefined loss {cfg.loss_type!r}; one of {loss_types}")
    if cfg.norm_type not in NORM_TYPES:
        raise ValueError(f"unknown norm type {cfg.norm_type!r}; one of {NORM_TYPES}")


def _check_dense_latent(cfg) -> None:
    """SRNN and VRNN: frames of 8·n pixels (the features are H/8 x W/8)."""
    _check_common(cfg, ("bernoulli", "gaussian", "mse", "mol"))
    if cfg.image_size % 8 or cfg.image_size < 8:
        raise ValueError(f"image_size {cfg.image_size}: a multiple of 8 is needed")
    if cfg.loss_type == "mol" and cfg.x_channels not in (1, 3):
        raise ValueError("the 'mol' likelihood takes 1 or 3 channels")


def _check_svg(cfg: SVGConfig) -> None:
    """SVG: a power-of-two image of at least 16 pixels."""
    _check_common(cfg, ("bernoulli", "mse", "gaussian"))
    n = cfg.image_size
    if n < 16 or n & (n - 1):
        raise ValueError(f"image_size {n}: SVG takes a power of two >= 16")


_CHECKS = {RFNConfig: _check_rfn, SRNNConfig: _check_dense_latent,
           VRNNConfig: _check_dense_latent, SVGConfig: _check_svg,
           GlowConfig: check_glow_supported}


def check_supported(cfg) -> None:
    """Raise on a config the port does not run (see module docstring)."""
    check = _CHECKS.get(type(cfg))
    if check is None:
        raise ValueError(f"{type(cfg).__name__}: the port's configs are RFNConfig, "
                         "SRNNConfig, VRNNConfig, SVGConfig and GlowConfig")
    check(cfg)
