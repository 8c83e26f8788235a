"""The port's `hapi` (`paddle_tpu/hapi/`): `Model`."""
from .model import Model

__all__ = ["Model"]
