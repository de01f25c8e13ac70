"""Neural network architectures (port of ambersim_tpu/learning/architectures.py).

`MLP` initializes as flax's `Dense` does in the JAX package: weights from
lecun_uniform (uniform in +-sqrt(3 / fan_in)) and zero biases. Its layers
are `hidden.<i>`, the counterparts of flax's `hidden_<i>`; an `nn.Linear`
weight is the transpose of a flax kernel (io/bridge.py converts them).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    """Multi-layer perceptron.

    Args:
      in_size: width of the input.
      layer_sizes: sizes of all layers, including the output layer.
      activation: applied after every layer but the last (and after the last
        too with `activate_final`); a module-level function, so the MLP
        pickles.
      bias: whether layers use bias terms.
    """

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        activate_final: bool = False,
        bias: bool = True,
    ):
        super().__init__()
        self.activation = activation
        self.activate_final = activate_final
        sizes = [in_size] + list(layer_sizes)
        self.hidden = nn.ModuleList(
            nn.Linear(a, b, bias=bias) for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh weights drawn from `generator` (torch's default one if None)."""
        for layer in self.hidden:
            limit = math.sqrt(3.0 / layer.in_features)
            layer.weight.uniform_(-limit, limit, generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.hidden) - 1
        for i, layer in enumerate(self.hidden):
            x = layer(x)
            if i != last or self.activate_final:
                x = self.activation(x)
        return x
