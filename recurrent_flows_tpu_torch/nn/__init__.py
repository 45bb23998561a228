from .convlstm import ConvLSTMCell, conv_lstm_scan
from .layers import Conv2d, NormLayer, SimpleParamNet, act, conv_nhwc
from .vgg import VGGDownscaler, VGGUpscaler, downscaler_layer_sizes

__all__ = ["Conv2d", "ConvLSTMCell", "NormLayer", "SimpleParamNet",
           "VGGDownscaler", "VGGUpscaler", "act", "conv_lstm_scan",
           "conv_nhwc", "downscaler_layer_sizes"]
