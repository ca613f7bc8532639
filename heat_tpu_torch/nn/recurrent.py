"""Recurrent layers (reference: ``heat_tpu/nn/recurrent.py``): RNN, LSTM, GRU and their cells.

Batch first: ``forward(x (B, S, F), h0=None) -> (out (B, S, H), final)``,
``final`` stacked over the layers, (num_layers, B, H), and for the LSTM an
``(h, c)`` pair of them; ``h0`` has the same form.  Each layer holds
``weight_ih`` (G·H, in), ``weight_hh`` (G·H, H), ``bias_ih`` and
``bias_hh`` under its index (``0.weight_ih``, ...), the reference's names,
uniform in ±1/sqrt(H), on the default device.  Gates in torch's packed
order: LSTM (i, f, g, o), GRU (r, z, n) with ``b_hn`` inside the reset
product, n = tanh(W_in x + b_in + r (W_hn h + b_hn)).  The layers run
ATen's fused RNN (``torch.lstm``, ``torch.gru``, ``torch.rnn_tanh``,
``torch.rnn_relu``): cuDNN on the card, which takes TF32 products unless
``torch.backends.cudnn.rnn`` says 'ieee' (``linalg.basics._full_float32``
sets it); the layer's weights are not one flat cuDNN buffer, so cuDNN
copies them into one each call.  The layers have no dropout, so the fused
RNN's training flag only keeps what its backward needs: it follows
``torch.is_grad_enabled()``, not the module's mode (cuDNN's backward
refuses a forward run for inference, and the reference differentiates
its layers in any mode).  The cells (``RNNCell``, ``LSTMCell``,
``GRUCell``) hold one layer's parameters flat and return the new state:
``h``, or ``(h, c)`` for the LSTM cell.
"""

from __future__ import annotations

import math
import warnings

import torch

from .modules import _device

__all__ = ["GRU", "GRUCell", "LSTM", "LSTMCell", "RNN", "RNNCell"]


class _Layer(torch.nn.Module):
    """One layer's packed weights and biases."""

    def __init__(self, in_features: int, hidden: int, gates: int, bias: bool, device, dtype):
        super().__init__()
        dev = _device(device)
        self.weight_ih = torch.nn.Parameter(torch.empty((gates * hidden, in_features), device=dev, dtype=dtype))
        self.weight_hh = torch.nn.Parameter(torch.empty((gates * hidden, hidden), device=dev, dtype=dtype))
        if bias:
            self.bias_ih = torch.nn.Parameter(torch.empty(gates * hidden, device=dev, dtype=dtype))
            self.bias_hh = torch.nn.Parameter(torch.empty(gates * hidden, device=dev, dtype=dtype))
        else:
            self.register_parameter("bias_ih", None)
            self.register_parameter("bias_hh", None)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        bound = 1.0 / math.sqrt(self.weight_hh.shape[1])
        for p in self.parameters():
            torch.nn.init.uniform_(p, -bound, bound)

    def flat(self) -> list:
        return [self.weight_ih, self.weight_hh] + ([self.bias_ih, self.bias_hh] if self.bias_ih is not None else [])


class _Recurrent(torch.nn.Module):
    GATES = 1

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.input_size, self.hidden_size, self.num_layers, self.bias = input_size, hidden_size, num_layers, bias
        for layer in range(num_layers):
            self.add_module(str(layer), _Layer(input_size if layer == 0 else hidden_size, hidden_size, self.GATES,
                                               bias, device, dtype))

    def _flat_weights(self) -> list:
        return [w for layer in self.children() for w in layer.flat()]

    def _zeros(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros((self.num_layers, x.shape[0], self.hidden_size))

    def _run(self, x, hx):
        raise NotImplementedError

    def _args(self) -> tuple:
        """The fused RNN's (params, has_biases, num_layers, dropout, train, bidirectional, batch_first)."""
        return self._flat_weights(), self.bias, self.num_layers, 0.0, torch.is_grad_enabled(), False, True

    def forward(self, x: torch.Tensor, h0=None):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*single contiguous chunk of memory.*")
            return self._run(x, h0)


class RNN(_Recurrent):
    """Elman RNN, ``tanh`` or ``relu``."""

    GATES = 1

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1, bias: bool = True,
                 nonlinearity: str = "tanh", device=None, dtype=None):
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"unknown nonlinearity {nonlinearity!r}")
        super().__init__(input_size, hidden_size, num_layers, bias, device, dtype)
        self.nonlinearity = nonlinearity

    def _run(self, x, hx):
        fn = torch.rnn_tanh if self.nonlinearity == "tanh" else torch.rnn_relu
        return fn(x, self._zeros(x) if hx is None else hx, *self._args())


class LSTM(_Recurrent):
    """LSTM, gates (i, f, g, o); the final state is (h, c)."""

    GATES = 4

    def _run(self, x, hx):
        hx = (self._zeros(x), self._zeros(x)) if hx is None else tuple(hx)
        out, h, c = torch.lstm(x, hx, *self._args())
        return out, (h, c)


class GRU(_Recurrent):
    """GRU, gates (r, z, n), ``b_hn`` inside the reset product."""

    GATES = 3

    def _run(self, x, hx):
        return torch.gru(x, self._zeros(x) if hx is None else hx, *self._args())


class _Cell(torch.nn.Module):
    """One step of the layer: one layer's parameters, flat."""

    GATES = 1

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size, self.bias = input_size, hidden_size, bias
        layer = _Layer(input_size, hidden_size, self.GATES, bias, device, dtype)
        for name, p in list(layer.named_parameters(recurse=False)):
            self.register_parameter(name, p)
        if not bias:
            self.register_parameter("bias_ih", None)
            self.register_parameter("bias_hh", None)

    def _zero(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros((x.shape[0], self.hidden_size))


class RNNCell(_Cell):
    GATES = 1

    def __init__(self, input_size: int, hidden_size: int, bias: bool = True, nonlinearity: str = "tanh",
                 device=None, dtype=None):
        if nonlinearity not in ("tanh", "relu"):
            raise ValueError(f"unknown nonlinearity {nonlinearity!r}")
        super().__init__(input_size, hidden_size, bias, device, dtype)
        self.nonlinearity = nonlinearity

    def forward(self, x: torch.Tensor, hx=None) -> torch.Tensor:
        fn = torch.rnn_tanh_cell if self.nonlinearity == "tanh" else torch.rnn_relu_cell
        return fn(x, self._zero(x) if hx is None else hx, self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class LSTMCell(_Cell):
    GATES = 4

    def forward(self, x: torch.Tensor, hx=None):
        hx = (self._zero(x), self._zero(x)) if hx is None else tuple(hx)
        return tuple(torch.lstm_cell(x, hx, self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh))


class GRUCell(_Cell):
    GATES = 3

    def forward(self, x: torch.Tensor, hx=None) -> torch.Tensor:
        return torch.gru_cell(x, self._zero(x) if hx is None else hx, self.weight_ih, self.weight_hh, self.bias_ih,
                              self.bias_hh)
