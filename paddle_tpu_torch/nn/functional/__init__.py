"""Functionals of the port's `nn` (`paddle_tpu/nn/functional/`): what
BERT and the Transformer encoder call."""
from .activation import gelu, relu, tanh
from .attention import scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["cross_entropy", "dropout", "embedding", "gelu", "layer_norm",
           "linear", "relu", "scaled_dot_product_attention", "tanh"]
