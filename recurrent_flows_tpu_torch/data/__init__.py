from .moving_mnist import MovingMNIST, sample_moving_mnist, synthetic_digit_bank

__all__ = ["MovingMNIST", "sample_moving_mnist", "synthetic_digit_bank"]
