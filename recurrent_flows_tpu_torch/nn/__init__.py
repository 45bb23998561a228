from .convlstm import ConvLSTMCell, conv_lstm_scan
from .dense_lstm import DenseLSTMCell, SVGGaussianLSTM, SVGLSTM
from .layers import (Conv2d, ConvTranspose2d, Dense, NormLayer, SimpleParamNet, act,
                     conv_nhwc)
from .vgg import VGGDownscaler, VGGUpscaler, downscaler_layer_sizes

__all__ = ["Conv2d", "ConvLSTMCell", "ConvTranspose2d", "Dense", "DenseLSTMCell",
           "NormLayer", "SVGGaussianLSTM", "SVGLSTM", "SimpleParamNet",
           "VGGDownscaler", "VGGUpscaler", "act", "conv_lstm_scan",
           "conv_nhwc", "downscaler_layer_sizes"]
