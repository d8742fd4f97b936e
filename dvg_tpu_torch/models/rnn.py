"""The `lstm` latent predictor (counterpart of `dvg_tpu/models/rnn.py`,
`lstm_init`/`lstm_hidden_init`/`lstm_apply`): Linear embed → stacked
LSTM cells (gate order i, f, g, o) → Linear + tanh. The hidden state is an
explicit value, (h, c) each stacked over layers as (n_layers, B, H).

The embed/output Linears take the N(0, 0.02) law (layers.init_weights);
the cells keep torch's U(−1/√H, 1/√H), drawn here from the generator.

`teacher_forced` is the training form (`dvg_tpu`'s lstm_teacher_forced):
its inputs are known up front, so embed and output run batched over time
and only the recurrence is sequential, as one `torch.lstm` call over the
cells' own weights (cuDNN's fused recurrence on the card).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dvg_tpu_torch.models.layers import cast

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

    def teacher_forced(self, x: torch.Tensor,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Predictions (T, B, output) for teacher-forced inputs x (T, B,
        input), from the zero state, every weight cast to `dtype` by a
        differentiable cast."""
        x = cast(x, dtype)
        e = F.linear(x, cast(self.embed.weight, dtype),
                     cast(self.embed.bias, dtype))
        flat = [cast(p, dtype) for cell in self.cells
                for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                          cell.bias_hh)]
        h0 = e.new_zeros((self.n_layers, x.shape[1], self.hidden_size))
        out, _, _ = torch.lstm(e, (h0, h0), flat, True, self.n_layers, 0.0,
                               torch.is_grad_enabled(), False, False)
        return torch.tanh(F.linear(out, cast(self.output.weight, dtype),
                                   cast(self.output.bias, dtype)))
