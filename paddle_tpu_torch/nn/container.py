"""`LayerList`, the port of `paddle_tpu/nn/container.py:LayerList`:
torch's `ModuleList`, which names its sublayers "0", "1", ... as paddle
does."""
import torch

LayerList = torch.nn.ModuleList
