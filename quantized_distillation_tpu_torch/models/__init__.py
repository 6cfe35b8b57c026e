"""Model families of the PyTorch port: the LSTM seq2seq, the CIFAR CNN, the
WideResNet, the ImageNet ResNets and the LSTM language model, under the JAX
package's names, and the DeepSeek-V2 decoder (MLA and mixture of experts),
which the port alone has."""

from .cnn import PRESETS as CNN_PRESETS
from .cnn import CNNSpec, ConvForwardNet, make_cnn
from .deepseek_v2 import DeepseekV2, DeepseekV2Config, make_deepseek_v2
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
    "DeepseekV2",
    "DeepseekV2Config",
    "make_deepseek_v2",
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
