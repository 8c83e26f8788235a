"""The port's `nn` (`paddle_tpu/nn/`): the layers and functionals BERT
runs on, as `torch.nn.Module`s under paddle's parameter names and
shapes. Every layer with parameters takes `device=`, defaulting to
"cuda"."""
from . import functional
from .container import LayerList
from .layers.activation import GELU, Tanh
from .layers.common import Dropout, Embedding, Linear
from .layers.norm import LayerNorm
from .layers.transformer import (MultiHeadAttention, TransformerEncoder,
                                 TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "GELU", "LayerList", "LayerNorm",
           "Linear", "MultiHeadAttention", "Tanh", "TransformerEncoder",
           "TransformerEncoderLayer", "functional"]
