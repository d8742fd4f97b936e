"""The `lstm` latent predictor (counterpart of `dvg_tpu/models/rnn.py`,
`lstm_init`/`lstm_hidden_init`/`lstm_apply`): Linear embed → stacked
LSTM cells (gate order i, f, g, o) → Linear + tanh. The hidden state is an
explicit value, (h, c) each stacked over layers as (n_layers, B, H).

The embed/output Linears take the N(0, 0.02) law (layers.init_weights);
the cells keep torch's U(−1/√H, 1/√H), drawn here from the generator.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

Hidden = Tuple[torch.Tensor, torch.Tensor]


class LSTMPredictor(nn.Module):
    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.embed = nn.Linear(input_size, hidden_size)
        self.cells = nn.ModuleList(nn.LSTMCell(hidden_size, hidden_size)
                                   for _ in range(n_layers))
        self.output = nn.Linear(hidden_size, output_size)

    @torch.no_grad()
    def init_cells(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for cell in self.cells:
            for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                      cell.bias_hh):
                p.uniform_(-bound, bound, generator=generator)

    def hidden_init(self, batch_size: int, dtype: torch.dtype,
                    device: torch.device) -> Hidden:
        z = torch.zeros((self.n_layers, batch_size, self.hidden_size),
                        dtype=dtype, device=device)
        return z, z

    def forward(self, hidden: Hidden, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Hidden]:
        """One step. x (B, input_size) → (out (B, output_size), hidden)."""
        h_stack, c_stack = hidden
        h_in = self.embed(x)
        hs, cs = [], []
        for i, cell in enumerate(self.cells):
            h_in, c_new = cell(h_in, (h_stack[i], c_stack[i]))
            hs.append(h_in)
            cs.append(c_new)
        out = torch.tanh(self.output(h_in))
        return out, (torch.stack(hs), torch.stack(cs))
