"""PyTorch/CUDA port of recurrent_flows_tpu (the JAX package is the reference).

Module paths and class names mirror ``recurrent_flows_tpu``; tensors keep
its NHWC layout at every public function. Importing this package imports
``torch`` only: it never imports JAX or Triton, initialises no CUDA
context and builds no kernel. Kernels are built on first launch.
"""

from .config import GlowConfig, RFNConfig, TrainConfig, check_supported, rfn_mnist_production

__all__ = ["GlowConfig", "RFNConfig", "TrainConfig", "check_supported",
           "rfn_mnist_production"]
