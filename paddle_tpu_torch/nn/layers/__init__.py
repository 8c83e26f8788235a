"""Layers of the port's `nn` (`paddle_tpu/nn/layers/`)."""
