from .bair import PushDataset
from .kth import KTH
from .moving_mnist import MovingMNIST, sample_moving_mnist, synthetic_digit_bank
from .shapes import MovingShapes, sample_moving_shapes

__all__ = ["KTH", "MovingMNIST", "MovingShapes", "PushDataset", "sample_moving_mnist",
           "sample_moving_shapes", "synthetic_digit_bank"]
