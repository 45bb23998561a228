from .schedules import BetaSchedule, EarlyStopping, PlateauScheduler, linear_lr
from .trainer import Trainer, bits_per_dim, clip_by_global_norm_, preprocess

__all__ = ["BetaSchedule", "EarlyStopping", "PlateauScheduler", "Trainer",
           "bits_per_dim", "clip_by_global_norm_", "linear_lr", "preprocess"]
