from .numerics import (
    NoiseSource,
    batch_reduce,
    float32_precision,
    free_bits_kl,
    normal_kl,
    normal_log_prob,
    normal_sample,
    split_feature,
    squeeze2d,
    unsqueeze2d,
)

__all__ = ["NoiseSource", "batch_reduce", "float32_precision",
           "free_bits_kl", "normal_kl", "normal_log_prob", "normal_sample", "split_feature", "squeeze2d", "unsqueeze2d"]
