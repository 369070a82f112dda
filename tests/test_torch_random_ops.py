"""The port's random ops (``ops/random.py``) against the JAX package's.

Torch's Philox / MT streams never equal JAX's threefry, so what is held
is the rest: every op's shape and dtype against JAX's (int64 where JAX's
code names it and JAX gives int32), its range, its first two moments at
n = 10^5 against the distribution's (and JAX's draw's), and ``seed``
reproducibility: the same seed, the same numbers; another, others."""

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.ops import random as jr

import paddle_tpu_torch as tp
from paddle_tpu_torch.ops import random as tr

N = 100_000


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _np(x):
    if hasattr(x, "_data"):
        return np.asarray(x._data)
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


_p = np.full((N,), 0.3, np.float32)
_lam = np.full((N,), 4.0, np.float32)
_probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)

# name, args (numpy arrays go in as each package's tensor), kwargs,
# (lo, hi) range or None, (mean, std) or None
CASES = [
    ("rand", ([N],), {}, (0.0, 1.0), (0.5, (1 / 12) ** 0.5)),
    ("randn", ([N],), {}, None, (0.0, 1.0)),
    ("standard_normal", ([N],), {}, None, (0.0, 1.0)),
    ("normal", (), {"mean": 2.0, "std": 3.0, "shape": [N]}, None,
     (2.0, 3.0)),
    ("uniform", ([N],), {"min": -2.0, "max": 4.0}, (-2.0, 4.0),
     (1.0, 6 / 12 ** 0.5)),
    ("randint", (0, 10, [N]), {}, (0, 9), (4.5, (99 / 12) ** 0.5)),
    ("randint_like", (np.zeros(N, np.float32), 0, 5), {}, (0, 4),
     (2.0, 2.0 ** 0.5)),
    ("randperm", (N,), {}, (0, N - 1), ((N - 1) / 2, None)),
    ("bernoulli", (_p,), {}, (0, 1), (0.3, (0.21) ** 0.5)),
    ("poisson", (_lam,), {}, (0, None), (4.0, 2.0)),
    ("rand_like", (np.zeros(N, np.float32),), {}, (0.0, 1.0),
     (0.5, (1 / 12) ** 0.5)),
    ("randn_like", (np.zeros(N, np.float32),), {}, None, (0.0, 1.0)),
    ("multinomial", (_probs, 1), {"replacement": False}, (0, 3), None),
]


def _call(mod, name, args, kwargs, jax_side):
    conv = (lambda a: jp.to_tensor(a)) if jax_side else torch.from_numpy
    args = [conv(a) if isinstance(a, np.ndarray) else a for a in args]
    return getattr(mod, name)(*args, **kwargs)


@pytest.mark.parametrize("name,args,kwargs,rng_,moments", CASES,
                         ids=[c[0] for c in CASES])
def test_random_op_matches_jax_in_distribution(name, args, kwargs, rng_,
                                               moments):
    j = _np(_call(jr, name, args, kwargs, True))
    tp.seed(7)
    t = _call(tr, name, args, kwargs, False)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    tn = _np(t)
    assert tn.shape == j.shape, name
    jdt = j.dtype.name
    tdt = str(t.dtype).replace("torch.", "")
    assert tdt == jdt or (jdt == "int32" and tdt == "int64"), (tdt, jdt)
    if rng_ is not None:
        lo, hi = rng_
        assert tn.min() >= lo and (hi is None or tn.max() <= hi)
        if isinstance(lo, int) and hi is not None and tn.size > 100:
            assert tn.min() == lo and tn.max() == hi      # covers range
    if moments is not None:
        mean, std = moments
        tol = 4 * (std if std else tn.std()) / N ** 0.5
        assert abs(tn.astype(np.float64).mean() - mean) < tol, name
        assert abs(j.astype(np.float64).mean() - mean) < tol, name
        if std:
            assert abs(tn.astype(np.float64).std() - std) < 0.02 * std
    # seed reproducibility on the device's generator
    tp.seed(7)
    again = _np(_call(tr, name, args, kwargs, False))
    np.testing.assert_array_equal(again, tn)
    tp.seed(8)
    other = _np(_call(tr, name, args, kwargs, False))
    assert not np.array_equal(other, tn)


def test_randperm_is_a_permutation_and_shuffle_keeps_rows():
    tp.seed(1)
    perm = tr.randperm(1000)
    assert sorted(perm.tolist()) == list(range(1000))
    x = torch.arange(12).reshape(6, 2)
    s = tr.shuffle(x)
    assert sorted(map(tuple, s.tolist())) == sorted(map(tuple, x.tolist()))
    assert _np(jr.shuffle(jp.to_tensor(x.numpy()))).shape == (6, 2)


def test_multinomial_with_replacement_frequencies():
    tp.seed(2)
    out = tr.multinomial(torch.from_numpy(_probs), N, replacement=True)
    freq = np.bincount(out.numpy(), minlength=4) / N
    np.testing.assert_allclose(freq, _probs, atol=0.01)
    j = _np(jr.multinomial(jp.to_tensor(_probs), N, replacement=True))
    np.testing.assert_allclose(np.bincount(j, minlength=4) / N, _probs,
                               atol=0.01)


def test_exponential_fills_in_place():
    tp.seed(3)
    x = torch.zeros(N)
    out = tr.exponential_(x, lam=2.0)
    assert out is x and x.min() > 0
    assert abs(x.double().mean().item() - 0.5) < 4 * 0.5 / N ** 0.5


def test_functional_forms_take_a_generator():
    g = torch.Generator().manual_seed(5)
    a = tr.uniform_p(g, [4], min=0.0, max=2.0)
    b = tr.normal_p(g, [4], mean=1.0)
    c = tr.randint_p(g, 0, 3, [4])
    d = tr.bernoulli_p(g, 0.5, [4])
    assert a.shape == b.shape == c.shape == d.shape == (4,)
    assert c.dtype == torch.int32 and d.dtype == torch.float32
    g2 = torch.Generator().manual_seed(5)
    torch.testing.assert_close(tr.uniform_p(g2, [4], min=0.0, max=2.0), a)


def test_rng_state_round_trip_and_seed_is_core_states():
    assert tr.seed is tp.seed and tr.get_rng_state is tp.get_rng_state
    tp.seed(9)
    st = tr.get_rng_state("cpu")
    a = tr.rand([5])
    tr.set_rng_state(st, "cpu")
    torch.testing.assert_close(tr.rand([5]), a)
