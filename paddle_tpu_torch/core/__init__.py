"""The port's `core` (`paddle_tpu/core/`): its random state."""
