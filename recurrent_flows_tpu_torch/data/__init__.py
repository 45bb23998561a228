from .bair import PushDataset
from .celeba import get_celeba, get_joint_conditioned_data, prepare_celeba
from .halfmoon import RotatingTwoMoonsConditionalSampler, two_moons
from .kth import KTH
from .moving_mnist import MovingMNIST, sample_moving_mnist, synthetic_digit_bank
from .shapes import MovingShapes, sample_moving_shapes
from .sinusoids import SinusWithNoise, sample_sinusoids

__all__ = ["KTH", "MovingMNIST", "MovingShapes", "PushDataset",
           "RotatingTwoMoonsConditionalSampler", "SinusWithNoise", "get_celeba",
           "get_joint_conditioned_data", "prepare_celeba", "sample_moving_mnist",
           "sample_moving_shapes", "sample_sinusoids", "synthetic_digit_bank", "two_moons"]
