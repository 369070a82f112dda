"""The hand-written op modules of the port against the JAX package's.

One case per public function of ``ops/creation.py``,
``manipulation.py``, ``linalg.py``, ``search.py``, ``stat.py``,
``array_ops.py``, ``logic.py``'s predicates and ``math.py``'s
hand-written ops (the random ops are ``test_torch_random_ops.py``'s):
the same seeded numpy inputs through JAX's function and the port's, with
fp32's tolerance (1e-5 / 1e-6) unless the case states its own.  Sorts run
on inputs with ties and must agree exactly, indices included;
``median`` runs on an even count; decompositions (qr, svd, eig, eigh)
are compared through their reconstructions.  JAX gives int32 where its
code names int64 (x64 is off); the port gives int64.

Also: the port's top level holds every op name JAX's top level takes
from ``ops/``; shapes may come as lists or tensors; ``name=`` is
swallowed; a creation op with no tensor input needs the card or
``set_device("cpu")``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jp

import chip_smoke
import paddle_tpu_torch as tp
from paddle_tpu.ops import (array_ops as j_array_ops, creation as j_creation,
                            linalg as j_linalg, logic as j_logic,
                            manipulation as j_manipulation, math as j_math,
                            search as j_search, stat as j_stat)
from paddle_tpu_torch.ops import (array_ops as t_array_ops,
                                  creation as t_creation,
                                  linalg as t_linalg, logic as t_logic,
                                  manipulation as t_manipulation,
                                  math as t_math, search as t_search,
                                  stat as t_stat)

MODULES = {"creation": (j_creation, t_creation),
           "manipulation": (j_manipulation, t_manipulation),
           "linalg": (j_linalg, t_linalg), "search": (j_search, t_search),
           "stat": (j_stat, t_stat), "math": (j_math, t_math),
           "logic": (j_logic, t_logic), "array_ops": (j_array_ops,
                                                      t_array_ops)}
HAND_MATH = ["mod", "floor_mod", "rsqrt_", "multiplex", "renorm",
             "cumulative_trapezoid", "histogram_bin_edges"]
PREDICATES = ["is_tensor", "is_floating_point", "is_integer", "is_complex"]


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _recon(op):
    def check(x, ref, got):
        chip_smoke.recon_check(op, x, [np.asarray(r) for r in ref], got)
    return check


# the cases chip_smoke.py's op_surface runs on the card
CASES = [pytest.param(mod, op, args, kwargs,
                      _recon(op) if op in chip_smoke.RECON else None,
                      rtol, atol, id=f"{mod}.{cid}")
         for mod, op, args, kwargs, cid, rtol, atol in
         chip_smoke.surface_cases()]


def _to_jax(v):
    if isinstance(v, chip_smoke.AsTensor):
        return jp.to_tensor(v.v)
    if isinstance(v, (np.ndarray, np.generic)):
        return jnp.asarray(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_to_jax(a) for a in v)
    return v


def _to_torch(v):
    if isinstance(v, chip_smoke.AsTensor):
        v = v.v
    if isinstance(v, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(v))
    if isinstance(v, (list, tuple)):
        return type(v)(_to_torch(a) for a in v)
    return v


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _jnp(x):
    if hasattr(x, "_data"):
        x = x._data
    return x


def _compare(name, j, t, rtol, atol):
    jl, tl = _leaves(j), _leaves(t)
    assert len(jl) == len(tl), (name, len(jl), len(tl))
    for i, (jv, tv) in enumerate(zip(jl, tl)):
        jv = _jnp(jv)
        what = f"{name} out{i}"
        if not isinstance(tv, torch.Tensor):
            assert tv == (jv if not hasattr(jv, "shape") else
                          np.asarray(jv).item()), what
            continue
        jn = np.asarray(jv)
        tdt = str(tv.dtype).replace("torch.", "")
        jdt = "bool" if jn.dtype == bool else jn.dtype.name
        assert tdt == jdt or (jdt == "int32" and tdt == "int64"), \
            (what, tdt, jdt)
        tn = tv.detach().resolve_conj().numpy()
        assert tn.shape == jn.shape, (what, tn.shape, jn.shape)
        if tn.dtype == bool or np.issubdtype(tn.dtype, np.integer):
            np.testing.assert_array_equal(tn, jn, err_msg=what)
        else:
            np.testing.assert_allclose(tn, jn, rtol=rtol, atol=atol,
                                       err_msg=what)


@pytest.mark.parametrize("mod,name,args,kwargs,check,rtol,atol", CASES)
def test_op_matches_jax(mod, name, args, kwargs, check, rtol, atol):
    jm, tm = MODULES[mod]
    j = getattr(jm, name)(*_to_jax(args), **kwargs)
    t = getattr(tm, name)(*_to_torch(args), **kwargs)
    if check is not None:
        check(args[0], [np.asarray(_jnp(v)) for v in _leaves(j)], t)
        return
    _compare(name, j, t, rtol, atol)


def test_every_hand_written_op_has_a_case():
    names = {(m, n) for m, n, *_ in (c.values for c in CASES)}
    for mod in ("creation", "manipulation", "linalg", "search", "stat",
                "array_ops"):
        want = set(MODULES[mod][0].__all__)
        assert want == set(MODULES[mod][1].__all__), mod
        assert want <= {n for m, n in names if m == mod}, \
            (mod, want - {n for m, n in names if m == mod})
    assert {n for m, n in names if m == "math"} == set(HAND_MATH)
    assert {n for m, n in names if m == "logic"} == set(PREDICATES)


def test_top_level_names_cover_jax_ops():
    """Every name JAX's top level binds from ``ops/`` is bound on the
    port's top level to the same module's op (JAX's import order)."""
    import types
    missing, moved = [], []
    for n in dir(jp):
        v = getattr(jp, n)
        mod = getattr(v, "__module__", "") or ""
        if isinstance(v, types.ModuleType) or not mod.startswith(
                "paddle_tpu.ops"):
            continue
        tv = getattr(tp, n, None)
        if tv is None:
            missing.append(n)
        elif tv.__module__ != mod.replace("paddle_tpu", "paddle_tpu_torch",
                                          1):
            moved.append((n, mod, tv.__module__))
    assert not missing and not moved, (missing, moved)
    assert tp.fft.__name__ == "paddle_tpu_torch.fft"
    assert tp.fft.rfft(torch.ones(8)).shape == (5,)
    assert tp.linalg.__name__ == "paddle_tpu_torch.ops.linalg"
    assert callable(tp.amp.auto_cast) and callable(tp.amp.decorate)
    assert tp.amp.GradScaler and tp.amp.debugging.collect_operator_stats


@pytest.mark.parametrize("fn,args,want", [
    ("arange", (5,), torch.int64), ("argmax", ("x",), torch.int64),
    ("argsort", ("x",), torch.int64), ("nonzero", ("x",), torch.int64),
    ("topk", ("x", 2), torch.int64), ("full", ([2], 3), torch.int64),
    ("numel", ("x",), torch.int64), ("kthvalue", ("x", 1), torch.int64),
])
def test_int64_where_jax_code_names_it(fn, args, want):
    """JAX truncates these to int32 (x64 off); the port gives the int64
    that JAX's code names (Paddle's dtype and torch's native one)."""
    x = torch.tensor([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]])
    out = getattr(tp, fn)(*[x if a == "x" else a for a in args])
    out = out[-1] if isinstance(out, tuple) else out
    assert out.dtype == want


def test_creation_needs_the_card_or_set_device_cpu(monkeypatch):
    """With no card and no ``set_device("cpu")``, an op with no tensor
    input raises rather than landing on the CPU; ``get_device`` speaks
    Paddle's names."""
    from paddle_tpu_torch.core import state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state.set_default_device("cuda")
    assert tp.get_device() == "gpu:0"
    for call in (lambda: tp.zeros([2]), lambda: tp.arange(3),
                 lambda: tp.randn([2]), lambda: tp.to_tensor([1.0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    tp.set_device("cpu")
    assert tp.get_device() == "cpu"
    assert tp.zeros([2]).device.type == "cpu"
    assert tp.to_tensor([1.0]).dtype == torch.float32
    with pytest.raises(ValueError):
        tp.set_device("tpu")
