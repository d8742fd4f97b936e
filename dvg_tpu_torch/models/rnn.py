"""The latent predictors (counterpart of `dvg_tpu/models/rnn.py`): the
`lstm` predictor (`lstm_init`/`lstm_hidden_init`/`lstm_apply`), Linear
embed → stacked LSTM cells (gate order i, f, g, o) → Linear + tanh; the
hidden state is an explicit value, (h, c) each stacked over layers as
(n_layers, B, H).

`GRUPredictor` and `RNNPredictor` (gru_*, rnn_*) wrap GRU (gate order r,
z, n) and tanh cells the same way, their hidden state one (n_layers, B, H)
tensor; `GaussianLSTMPredictor` (gaussian_lstm_*) puts mu and logvar heads
on the LSTM trunk and returns the reparameterized sample mu + exp(logvar /
2)·eps from an eps the caller gives. The reference's scripts use none of
these three; they are here for capability parity, off the card's path.

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


@torch.no_grad()
def init_cells(cells: nn.ModuleList, hidden_size: int,
               generator: torch.Generator) -> None:
    """torch's U(−1/√H, 1/√H) over every cell's weight_ih, weight_hh,
    bias_ih and bias_hh, in that order, from the generator."""
    bound = 1.0 / math.sqrt(hidden_size)
    for cell in cells:
        for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                  cell.bias_hh):
            p.uniform_(-bound, bound, generator=generator)


def _lstm_step(m: nn.Module, hidden: Hidden, x: torch.Tensor
               ) -> Tuple[torch.Tensor, Hidden]:
    """m's embed, then its stacked LSTM cells, one step → (the top cell's
    h, the new hidden)."""
    h_stack, c_stack = hidden
    h_in = m.embed(x)
    hs, cs = [], []
    for i, cell in enumerate(m.cells):
        h_in, c_new = cell(h_in, (h_stack[i], c_stack[i]))
        hs.append(h_in)
        cs.append(c_new)
    return h_in, (torch.stack(hs), torch.stack(cs))


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

    def init_cells(self, generator: torch.Generator) -> None:
        init_cells(self.cells, self.hidden_size, generator)

    def hidden_init(self, batch_size: int, dtype: torch.dtype,
                    device: torch.device) -> Hidden:
        z = torch.zeros((self.n_layers, batch_size, self.hidden_size),
                        dtype=dtype, device=device)
        return z, z

    def forward(self, hidden: Hidden, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Hidden]:
        """One step. x (B, input_size) → (out (B, output_size), hidden)."""
        h_in, hidden = _lstm_step(self, hidden, x)
        return torch.tanh(self.output(h_in)), hidden

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


class _CellStack(nn.Module):
    """Linear embed → n_layers stacked GRU or tanh RNN cells → Linear +
    tanh, the hidden state (n_layers, B, H) (`dvg_tpu`'s gru_apply and
    rnn_apply)."""

    def __init__(self, cell, input_size: int, output_size: int,
                 hidden_size: int, n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.embed = nn.Linear(input_size, hidden_size)
        self.cells = nn.ModuleList(cell(hidden_size, hidden_size)
                                   for _ in range(n_layers))
        self.output = nn.Linear(hidden_size, output_size)

    def init_cells(self, generator: torch.Generator) -> None:
        init_cells(self.cells, self.hidden_size, generator)

    def hidden_init(self, batch_size: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        return torch.zeros((self.n_layers, batch_size, self.hidden_size),
                           dtype=dtype, device=device)

    def forward(self, hidden: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step. x (B, input_size) → (out (B, output_size), hidden)."""
        h_in = self.embed(x)
        hs = []
        for i, cell in enumerate(self.cells):
            h_in = cell(h_in, hidden[i])
            hs.append(h_in)
        return torch.tanh(self.output(h_in)), torch.stack(hs)


class GRUPredictor(_CellStack):
    """The `gru` predictor (reference lstm.py:75-104)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int):
        super().__init__(nn.GRUCell, input_size, output_size, hidden_size,
                         n_layers)


class RNNPredictor(_CellStack):
    """The `rnn` predictor, tanh cells (reference lstm.py:107-136)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int):
        super().__init__(nn.RNNCell, input_size, output_size, hidden_size,
                         n_layers)


class GaussianLSTMPredictor(nn.Module):
    """The `gaussian_lstm` predictor (reference lstm.py:140-175): the LSTM
    trunk with mu and logvar heads."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int,
                 n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.embed = nn.Linear(input_size, hidden_size)
        self.cells = nn.ModuleList(nn.LSTMCell(hidden_size, hidden_size)
                                   for _ in range(n_layers))
        self.mu = nn.Linear(hidden_size, output_size)
        self.logvar = nn.Linear(hidden_size, output_size)

    init_cells = LSTMPredictor.init_cells
    hidden_init = LSTMPredictor.hidden_init

    def forward(self, hidden: Hidden, x: torch.Tensor, eps: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                           Hidden]:
        """One step. x (B, input_size), eps (B, output_size) standard
        normal → ((z, mu, logvar), hidden)."""
        h_in, hidden = _lstm_step(self, hidden, x)
        mu, logvar = self.mu(h_in), self.logvar(h_in)
        return (mu + torch.exp(0.5 * logvar) * eps, mu, logvar), hidden
