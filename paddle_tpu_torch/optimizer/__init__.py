"""The port's `optimizer` (`paddle_tpu/optimizer/`): the base, `Lamb`,
and the learning-rate schedulers of BERT's recipe."""
from . import lr
from .optimizer import Optimizer
from .optimizers import Lamb

__all__ = ["Lamb", "Optimizer", "lr"]
