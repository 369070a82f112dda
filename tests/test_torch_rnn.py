"""The port's recurrent layers against the JAX package's on the CPU, with
copied weights and the same seeded inputs: the three cells one step, and
``RNN`` / ``BiRNN`` / the stacked ``SimpleRNN``, ``LSTM`` and ``GRU`` over a
sequence (outputs, final states, gradients), with ``time_major``,
``direction``, initial states and the weight names.  fp32; the port
projects every step's input at once and XLA scans step by step, so the
sums differ in order: 1e-5 relative with 1e-5 absolute."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu.nn as jnn

import paddle_tpu_torch.nn as tnn

TOL = 1e-5


def _r(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else x.numpy()


def _close(t, j, rtol=TOL, atol=TOL):
    if isinstance(t, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close(a, b, rtol, atol)
        return
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


def _pair(cls, *args, **kw):
    pp.seed(0)
    jl = getattr(jnn, cls)(*args, **kw)
    tl = getattr(tnn, cls)(*args, **kw)
    state = {k: v.numpy() for k, v in jl.state_dict().items()}
    assert list(tl.state_dict()) == list(state)
    tl.set_state_dict(state)
    return jl, tl


@pytest.mark.parametrize("cls,kw", [("SimpleRNNCell", {}),
                                    ("SimpleRNNCell", {"activation": "relu"}),
                                    ("LSTMCell", {}), ("GRUCell", {})])
def test_cell_step_matches_jax(cls, kw):
    jl, tl = _pair(cls, 5, 7, **kw)
    x = _r((3, 5), 1)
    _close(tl(torch.from_numpy(x)), jl(pp.to_tensor(x)))
    if cls == "LSTMCell":
        h, c = _r((3, 7), 2), _r((3, 7), 3)
        st_j = (pp.to_tensor(h), pp.to_tensor(c))
        st_t = (torch.from_numpy(h), torch.from_numpy(c))
    else:
        h = _r((3, 7), 2)
        st_j, st_t = pp.to_tensor(h), torch.from_numpy(h)
    _close(tl(torch.from_numpy(x), st_t), jl(pp.to_tensor(x), st_j))


def test_cell_names_and_init_bounds():
    tl = tnn.LSTMCell(6, 10)
    assert list(tl.state_dict()) == ["weight_ih", "weight_hh", "bias_ih",
                                     "bias_hh"]
    assert tuple(tl.weight_ih.shape) == (40, 6)
    assert tuple(tl.weight_hh.shape) == (40, 10)
    bound = 1.0 / np.sqrt(10)
    assert all(float(p.abs().max()) <= bound for p in tl.parameters())
    g = tnn.GRUCell(6, 10, bias_ih_attr=False)
    assert g.bias_ih is None and tuple(g.weight_ih.shape) == (30, 6)


@pytest.mark.parametrize("cell,reverse,time_major", [
    ("LSTMCell", False, False), ("GRUCell", True, False),
    ("SimpleRNNCell", False, True)])
def test_rnn_wrapper_matches_jax(cell, reverse, time_major):
    pp.seed(0)
    jl = jnn.RNN(getattr(jnn, cell)(4, 6), is_reverse=reverse,
                 time_major=time_major)
    tl = tnn.RNN(getattr(tnn, cell)(4, 6), is_reverse=reverse,
                 time_major=time_major)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    x = _r((5, 3, 4) if time_major else (3, 5, 4), 4)
    jo, js = jl(pp.to_tensor(x))
    to, ts = tl(torch.from_numpy(x))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("cls,direction,layers,time_major", [
    ("LSTM", "forward", 2, False),
    ("GRU", "bidirect", 2, False),
    ("SimpleRNN", "bidirectional", 1, True),
    ("LSTM", "bidirect", 1, False),
])
def test_stacked_rnn_matches_jax(cls, direction, layers, time_major):
    jl, tl = _pair(cls, 4, 6, num_layers=layers, direction=direction,
                   time_major=time_major)
    x = _r((7, 3, 4) if time_major else (3, 7, 4), 5)
    jx = pp.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jo, jf = jl(jx)
    to, tf = tl(tx)
    _close(to, jo)
    assert len(tf) == len(jf) == layers
    _close(tf, jf)
    g = _r(tuple(to.shape), 6)
    (jo * pp.to_tensor(g)).sum().backward()
    (to * torch.from_numpy(g)).sum().backward()
    _close(tx.grad, jx.grad)
    jgrads = {k: v for k, v in jl.state_dict().items()}
    for name, p in tl.named_parameters():
        jp = jgrads[name]
        assert jp.grad is not None, name
        _close(p.grad, jp.grad, atol=1e-5)


def test_lstm_initial_states_forms_match_jax():
    """``(h0, c0)`` with a leading ``num_layers * num_directions`` axis,
    and a list of per-layer states (3 layers: with 2, JAX's reading of a
    2-tuple as per-layer states comes first, in both packages)."""
    jl, tl = _pair("LSTM", 4, 5, num_layers=3)
    x = _r((2, 6, 4), 7)
    h0, c0 = _r((3, 2, 5), 8), _r((3, 2, 5), 9)
    jo, jf = jl(pp.to_tensor(x), (pp.to_tensor(h0), pp.to_tensor(c0)))
    to, tf = tl(torch.from_numpy(x), (torch.from_numpy(h0),
                                      torch.from_numpy(c0)))
    _close(to, jo)
    _close(tf, jf)
    states = [(torch.from_numpy(h0[i]), torch.from_numpy(c0[i]))
              for i in range(3)]
    to2, _ = tl(torch.from_numpy(x), states)
    _close(to2, to, atol=0, rtol=0)


def test_gru_initial_state_and_dropout_eval():
    jl, tl = _pair("GRU", 4, 5, num_layers=2, dropout=0.5)
    jl.eval()
    tl.eval()
    x, h0 = _r((2, 6, 4), 10), _r((2, 2, 5), 11)
    jo, _ = jl(pp.to_tensor(x), [pp.to_tensor(h0[0]), pp.to_tensor(h0[1])])
    to, _ = tl(torch.from_numpy(x), [torch.from_numpy(h0[0]),
                                     torch.from_numpy(h0[1])])
    _close(to, jo)
