"""Model families of the PyTorch port: the LSTM seq2seq, the CIFAR CNN, the
WideResNet, the ImageNet ResNets and the LSTM language model, under the JAX
package's names."""

from .cnn import PRESETS as CNN_PRESETS
from .cnn import CNNSpec, ConvForwardNet, make_cnn
from .lm import LM_PRESETS, LMConfig, LSTMLanguageModel, make_lm
from .resnet import RESNET_PRESETS, BottleneckBlock, ResNet, ResNetBlock, make_resnet
from .seq2seq import (
    SEQ2SEQ_PRESETS,
    DecoderState,
    Encoder,
    LuongAttention,
    Seq2Seq,
    Seq2SeqConfig,
    make_seq2seq,
)
from .wide_resnet import WRN_PRESETS, BasicBlock, WideResNet, make_wrn

__all__ = [
    "CNN_PRESETS",
    "CNNSpec",
    "ConvForwardNet",
    "make_cnn",
    "LM_PRESETS",
    "LMConfig",
    "LSTMLanguageModel",
    "make_lm",
    "SEQ2SEQ_PRESETS",
    "DecoderState",
    "Encoder",
    "LuongAttention",
    "Seq2Seq",
    "Seq2SeqConfig",
    "make_seq2seq",
    "WRN_PRESETS",
    "BasicBlock",
    "WideResNet",
    "make_wrn",
    "RESNET_PRESETS",
    "ResNet",
    "ResNetBlock",
    "BottleneckBlock",
    "make_resnet",
]
