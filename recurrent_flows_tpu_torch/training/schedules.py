"""Host-side training schedules (beta annealing, learning rate, early
stopping), the counterparts of ``recurrent_flows_tpu.training.schedules``."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BetaSchedule:
    """beta = min(max, min + counter * (max - min) / steps)."""

    beta_max: float = 1.0
    beta_min: float = 1e-7
    steps: int = 12_000

    def __call__(self, counter: int) -> float:
        return min(
            self.beta_max,
            self.beta_min + counter * (self.beta_max - self.beta_min) / self.steps,
        )


def linear_lr(base_lr: float, step: int, start_step: int = 100_000,
              num_steps: int = 150_000):
    """Linear decay to zero after ``start_step``: (lr, stop); ``stop``
    turns True when the rate has all but reached zero."""
    if step <= start_step:
        return base_lr, False
    lr = base_lr - (step - start_step) * base_lr / num_steps
    stop = step >= (start_step + num_steps - 5)
    return max(lr, 0.0), stop


class PlateauScheduler:
    """lr *= factor after ``patience`` epochs without improvement."""

    def __init__(self, base_lr: float, patience: int, factor: float, min_lr: float):
        self.lr = base_lr
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class EarlyStopping:
    """Stop after ``patience`` epochs without improvement by ``min_delta``."""

    def __init__(self, patience: int = 50, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best_loss = float("inf")
        self.wait = 0

    def step(self, loss: float) -> bool:
        if loss is None:
            return False
        if (loss - self.best_loss) < -self.min_delta:
            self.best_loss = loss
            self.wait = 1
            return False
        if self.wait >= self.patience:
            return True
        self.wait += 1
        return False
