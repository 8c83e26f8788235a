"""The port's `amp` (`paddle_tpu/amp/`): `decorate` at O2."""
from .auto_cast import auto_cast, decorate

__all__ = ["auto_cast", "decorate"]
