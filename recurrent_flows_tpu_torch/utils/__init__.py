from .numerics import (
    NoiseSource,
    RecordingNoise,
    batch_reduce,
    draw_list,
    float32_precision,
    free_bits_kl,
    normal_kl,
    normal_log_prob,
    normal_sample,
    pad_same,
    split_feature,
    squeeze2d,
    unsqueeze2d,
)

__all__ = ["NoiseSource", "RecordingNoise", "batch_reduce", "draw_list", "float32_precision",
           "free_bits_kl", "normal_kl", "normal_log_prob", "normal_sample", "pad_same", "split_feature", "squeeze2d", "unsqueeze2d"]
