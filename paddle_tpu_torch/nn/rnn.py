"""Recurrent layers (``paddle_tpu/nn/rnn.py``): ``SimpleRNNCell``,
``LSTMCell``, ``GRUCell``, ``RNN``, ``BiRNN`` and the stacked
``SimpleRNN``, ``LSTM`` and ``GRU``.

The JAX package's layouts and names: ``weight_ih`` ``[gates * hidden,
input]``, ``weight_hh`` ``[gates * hidden, hidden]``, ``bias_ih`` /
``bias_hh``, all initialised ``U(-1/sqrt(hidden), 1/sqrt(hidden))``;
gate order i, f, c, o for the LSTM and r, z, c for the GRU (whose
candidate is ``tanh(x W_c + b_ic + r * (h U_c + b_hc))``); zero initial
states; ``time_major`` and ``direction`` (``"forward"``,
``"bidirect"`` / ``"bidirectional"``); stacked layers named
``rnns.{i}.cell.*``, or ``rnns.{i}.rnn_fw.cell.*`` / ``rnn_bw`` when
bidirectional.  ``sequence_length`` is taken and, as there, not read.

The JAX package scans the cell with ``lax.scan``; here the time loop is
Python over the cell's step, with the input projection of every step
done first as one product (``x W_ih^T + b_ih`` for the whole sequence).
Each step is then one product and the gates' elementwise ops; autograd
records the loop."""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN",
           "LSTM", "GRU", "BiRNN"]


class _RNNCellBase(Layer):
    _gates = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self._gates
        std = 1.0 / math.sqrt(hidden_size)
        u = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            [g * hidden_size, input_size], attr=weight_ih_attr,
            default_initializer=u)
        self.weight_hh = self.create_parameter(
            [g * hidden_size, hidden_size], attr=weight_hh_attr,
            default_initializer=u)
        self.bias_ih = None if bias_ih_attr is False else \
            self.create_parameter([g * hidden_size], attr=bias_ih_attr,
                                  is_bias=True, default_initializer=u)
        self.bias_hh = None if bias_hh_attr is False else \
            self.create_parameter([g * hidden_size], attr=bias_hh_attr,
                                  is_bias=True, default_initializer=u)

    def _project(self, x):
        """``x W_ih^T (+ b_ih)`` over any leading axes."""
        z = torch.matmul(x, self.weight_ih.t())
        return z if self.bias_ih is None else z + self.bias_ih

    def _recur(self, h):
        z = torch.matmul(h, self.weight_hh.t())
        return z if self.bias_hh is None else z + self.bias_hh

    def _zeros(self, x):
        return torch.zeros((x.shape[0], self.hidden_size), dtype=x.dtype,
                           device=x.device)

    def initial_state(self, x):
        return self._zeros(x)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.initial_state(inputs)
        out, new = self._step(self._project(inputs), states)
        return out, new


class SimpleRNNCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, dtype="float32", device=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, dtype,
                         device)
        self.activation = activation

    def _step(self, xz, h):
        z = xz + self._recur(h)
        h = torch.tanh(z) if self.activation == "tanh" else torch.relu(z)
        return h, h


class LSTMCell(_RNNCellBase):
    _gates = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, dtype="float32", device=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, dtype,
                         device)

    def initial_state(self, x):
        z = self._zeros(x)
        return (z, z)

    def _step(self, xz, state):
        h, c = state
        i, f, g, o = torch.chunk(xz + self._recur(h), 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(_RNNCellBase):
    _gates = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, dtype="float32", device=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, dtype,
                         device)

    def _step(self, xz, h):
        ri, zi, ci = torch.chunk(xz, 3, dim=-1)
        rh, zh, ch = torch.chunk(self._recur(h), 3, dim=-1)
        r = torch.sigmoid(ri + rh)
        z = torch.sigmoid(zi + zh)
        c = torch.tanh(ci + r * ch)
        h = (1 - z) * c + z * h
        return h, h


class RNN(Layer):
    """A cell over time: ``(outputs, final state)``; outputs ``[B, T,
    hidden]`` (``[T, B, hidden]`` with ``time_major``), reversed in time
    with ``is_reverse`` and put back in input order."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        xz = self.cell._project(x)                 # [T, B, gates * H]
        state = initial_states if initial_states is not None else \
            self.cell.initial_state(x[0])
        steps = range(x.shape[0] - 1, -1, -1) if self.is_reverse else \
            range(x.shape[0])
        outs = [None] * x.shape[0]
        for t in steps:
            outs[t], state = self.cell._step(xz[t], state)
        out = torch.stack(outs, 0)
        return (out if self.time_major else out.transpose(0, 1)), state


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = initial_states if initial_states is not None \
            else (None, None)
        out_fw, st_fw = self.rnn_fw(inputs, st_fw)
        out_bw, st_bw = self.rnn_bw(inputs, st_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _StackedRNNBase(Layer):
    _cell_cls = None
    _is_lstm = False

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, dtype="float32", device=None,
                 **cell_kwargs):
        super().__init__(dtype=dtype, device=device)
        from paddle_tpu_torch.nn.common_layers import LayerList
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr, dtype=dtype, device=device,
                  **cell_kwargs)
        self.rnns = LayerList()
        num_dir = 2 if self.bidirectional else 1
        for i in range(num_layers):
            n_in = input_size if i == 0 else hidden_size * num_dir
            if self.bidirectional:
                self.rnns.append(BiRNN(self._cell_cls(n_in, hidden_size, **kw),
                                       self._cell_cls(n_in, hidden_size, **kw),
                                       time_major=time_major))
            else:
                self.rnns.append(RNN(self._cell_cls(n_in, hidden_size, **kw),
                                     time_major=time_major))

    def _layer_state(self, initial_states, i):
        """Layer i's initial state from the JAX package's accepted forms:
        a list of per-layer states, or for the LSTM ``(h0, c0)`` with a
        leading ``num_layers * num_directions`` axis."""
        if initial_states is None:
            return None
        if isinstance(initial_states, (list, tuple)) and \
                len(initial_states) == self.num_layers:
            return initial_states[i]
        if self._is_lstm and isinstance(initial_states, tuple) and \
                len(initial_states) == 2:
            h0, c0 = initial_states
            if not self.bidirectional:
                return (h0[i], c0[i])
            return ((h0[2 * i], c0[2 * i]), (h0[2 * i + 1], c0[2 * i + 1]))
        return None if self._is_lstm else initial_states[i]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out = inputs
        finals = []
        for i, rnn in enumerate(self.rnns):
            out, st = rnn(out, self._layer_state(initial_states, i))
            finals.append(st)
            if self.dropout and i < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout, training=self.training)
        return out, finals


class SimpleRNN(_StackedRNNBase):
    _cell_cls = SimpleRNNCell


class LSTM(_StackedRNNBase):
    _cell_cls = LSTMCell
    _is_lstm = True


class GRU(_StackedRNNBase):
    _cell_cls = GRUCell
