"""The port's op schema against the JAX package's.

``paddle_tpu_torch/ops/gen/ops.yaml`` is the port's own copy of
``paddle_tpu/ops/gen/ops.yaml``: the same 304 ops with the same args,
attrs and defaults (and sharding, doc, oracle, test), a torch ``impl``.
Every entry with a test runs once here: the inputs of the JAX package's
OpTest harness (seeded numpy) go through JAX's generated op and the
port's, which must agree within the entry's tolerance (fp32's 1e-5 /
1e-6 where it states none) and with the numpy oracle; where the entry's
test allows, torch's gradient of a random projection equals
``jax.vjp``'s.  JAX gives int32 where its code names int64 (x64 is
off); the port gives the int64 the code names."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch
import chip_smoke
from paddle_tpu.ops import generated_math as jgm
from paddle_tpu.ops.gen import generate as jgen
from paddle_tpu.testing import _rand, _tol_for
from paddle_tpu_torch.ops import generated_math as tgm
from paddle_tpu_torch.ops.gen import generate as tgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENTRIES = jgen.load_entries()
ENTRIES = tgen.load_entries()


@pytest.fixture(autouse=True)
def _cpu_default():
    from paddle_tpu_torch.core import state
    before = state.get_default_device()
    state.set_default_device("cpu")
    yield
    state.set_default_device(before)


def test_schema_is_jax_schema_with_torch_impls():
    """Same ops in the same order, same args, attrs and defaults, and
    the same sharding, doc, oracle and test; only impl differs."""
    assert len(ENTRIES) == len(JAX_ENTRIES) == 304
    for j, t in zip(JAX_ENTRIES, ENTRIES):
        assert t["op"] == j["op"]
        assert t["args"] == j["args"], t["op"]
        assert (t.get("attrs") or []) == (j.get("attrs") or []), t["op"]
        for key in ("sharding", "doc", "oracle", "test", "vjp"):
            assert t.get(key) == j.get(key), (t["op"], key)
        assert "jnp." not in t["impl"] and "jax." not in t["impl"], t["op"]


def test_generated_file_in_sync():
    path = os.path.join(ROOT, "paddle_tpu_torch", "ops", "generated_math.py")
    with open(path) as f:
        on_disk = f.read()
    assert on_disk == tgen.gen_module(ENTRIES), (
        "generated_math.py is out of sync with ops.yaml — run "
        "python -m paddle_tpu_torch.ops.gen.generate")


def test_op_info_and_signatures_match_jax():
    import inspect
    assert set(tgm.OP_INFO) == set(jgm.OP_INFO)
    for name, info in jgm.OP_INFO.items():
        assert tgm.OP_INFO[name] == info, name
        js = inspect.signature(jgm.__dict__[f"_{name}_pure"])
        ts = inspect.signature(tgm.__dict__[f"_{name}_pure"])
        assert str(js) == str(ts), name
        assert getattr(tgm, name).__op_name__ == name


def _oracle_fn(entry):
    expr = entry.get("oracle")
    if expr is None:
        return None
    args = list(entry["args"])

    def fn(*vals, **attrs):
        ns = {"np": np, "sps": sps}
        ns.update(zip(args, vals))
        for a in entry.get("attrs") or []:
            if not a.get("required"):
                ns[a["name"]] = eval(a["default"], {"None": None})
        ns.update(attrs)
        return eval(expr, ns)  # noqa: S307 — in-repo schema strings
    return fn


def _case(entry):
    """(inputs, attrs, grad names, out_index, rtol, atol) of the entry's
    first OpTest case (the JAX harness's inputs, as chip_smoke.py's
    op_surface builds them on the card), or None for a skip /
    oracle-less entry."""
    t = entry.get("test") or {}
    kind = t.get("kind", "skip")
    if kind == "skip" or entry.get("oracle") is None:
        return None
    inputs, attrs, rtol, atol = chip_smoke.schema_case(
        entry["op"], {"args": entry["args"], **t})
    grad = t.get("grad", True)
    if kind == "expr":
        names = grad if isinstance(grad, list) else []
    else:
        names = list(inputs) if grad else []
    return inputs, attrs, names, t.get("out_index", 0), rtol, atol


CASES = [pytest.param(e, id=e["op"]) for e in ENTRIES if _case(e)]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.resolve_conj().numpy()
    return np.asarray(x)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _dtype_ok(t_out, j_out):
    jt = np.dtype(j_out.dtype)
    tt = np.dtype(str(t_out.dtype).replace("torch.", "")) \
        if t_out.dtype != torch.bool else np.dtype(bool)
    return tt == jt or (jt == np.int32 and tt == np.int64)


def test_schema_has_a_case_for_every_tested_entry():
    """Every entry but the skips (and the few without an oracle) runs."""
    assert len(CASES) >= 250


@pytest.mark.parametrize("entry", CASES)
def test_op_matches_jax_and_oracle(entry):
    inputs, attrs, names, out_index, rtol, atol = _case(entry)
    jop = getattr(jgm, entry["op"])
    top = getattr(tgm, entry["op"])
    arrays = [jnp.asarray(v) for v in inputs.values()]
    want = _flat(jop(*arrays, **attrs))
    tens = [torch.from_numpy(np.array(v)) for v in inputs.values()]
    got = _flat(top(*tens, **attrs))
    oracle = _flat(_oracle_fn(entry)(*inputs.values(), **attrs))
    r, a = _tol_for(arrays[0].dtype if arrays else np.float32, rtol, atol)
    assert len(got) == len(want), entry["op"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert _dtype_ok(g, w), (entry["op"], i, g.dtype, w.dtype)
        gn, wn = _np(g), np.asarray(w)
        assert gn.shape == wn.shape, (entry["op"], i)
        if gn.dtype == bool or np.issubdtype(gn.dtype, np.integer):
            np.testing.assert_array_equal(gn, wn, err_msg=entry["op"])
        else:
            np.testing.assert_allclose(gn, wn, rtol=r, atol=a,
                                       err_msg=entry["op"])
        if i < len(oracle) and oracle[i] is not None:
            ref = np.asarray(oracle[i])
            if gn.dtype == bool or np.issubdtype(gn.dtype, np.integer):
                np.testing.assert_array_equal(gn, ref.astype(gn.dtype))
            else:
                np.testing.assert_allclose(gn, ref.astype(gn.dtype),
                                           rtol=r, atol=a,
                                           err_msg=entry["op"])
    if not names:
        return
    # gradients of sum(out * w), w fixed random: torch's against jax.vjp
    order = list(inputs)
    idx = [order.index(n) for n in names]
    out0 = want[out_index]
    w = np.random.default_rng(0).standard_normal(
        np.shape(out0)).astype(np.float32)

    def f(*diff):
        full = list(arrays)
        for i, d in zip(idx, diff):
            full[i] = d
        return _flat(jop(*full, **attrs))[out_index]

    _, vjp = jax.vjp(f, *[arrays[i] for i in idx])
    jgrads = vjp(jnp.asarray(w, out0.dtype))
    for i in idx:
        tens[i].requires_grad_(True)
    out_t = _flat(top(*tens, **attrs))[out_index]
    tgrads = torch.autograd.grad((out_t.float() * torch.from_numpy(w)).sum(),
                                 [tens[i] for i in idx])
    for n, tg, jg in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5,
                                   err_msg=f"{entry['op']} d/d{n}")


@pytest.mark.parametrize("name", ["rsqrt", "reciprocal", "square"])
def test_custom_vjp_entries(name):
    """The three entries with a ``vjp`` are autograd Functions whose
    backward is the schema's expression, equal to ``jax.vjp``'s."""
    assert [e["op"] for e in ENTRIES if e.get("vjp")] == \
        ["rsqrt", "reciprocal", "square"]
    assert tgm.OP_INFO[name]["custom_vjp"]
    x = _rand((5,), np.float32, 0.5, 2.0)
    g = np.linspace(-1, 1, 5).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = getattr(tgm, name)(xt)
    assert type(out.grad_fn).__name__.startswith(f"_{name}_fn")
    (gt,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    _, vjp = jax.vjp(getattr(jgm, name), jnp.asarray(x))
    np.testing.assert_allclose(gt.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-7)


# the entries whose test is "skip" (or that carry no oracle): the inputs
# chip_smoke.py's op_surface gives them, through both packages
EXTRA = [pytest.param(n, id=n) for n in chip_smoke.SCHEMA_EXTRA]


def test_extra_inputs_cover_every_untested_entry():
    assert {e["op"] for e in ENTRIES if not _case(e)} == \
        set(chip_smoke.SCHEMA_EXTRA)


@pytest.mark.parametrize("name", EXTRA)
def test_untested_entry_matches_jax(name):
    spec = tgm.OP_TESTS[name]
    inputs, attrs, rtol, atol = chip_smoke.schema_case(name, spec)

    def conv(v, to):
        if isinstance(v, list):
            return [to(a) for a in v]
        return to(v)
    want = _flat(getattr(jgm, name)(
        *[conv(v, jnp.asarray) for v in inputs.values()], **attrs))
    got = _flat(getattr(tgm, name)(
        *[conv(v, lambda a: torch.from_numpy(np.array(a)))
          for v in inputs.values()], **attrs))
    if name in chip_smoke.RECON:
        x = next(iter(inputs.values()))
        chip_smoke.recon_check(name, x, [np.asarray(w) for w in want], got)
        return
    assert len(got) == len(want), name
    r, a = _tol_for(np.float32, rtol, atol)
    for g, w in zip(got, want):
        assert _dtype_ok(g, w), (name, g.dtype, w.dtype)
        gn, wn = _np(g), np.asarray(w)
        assert gn.shape == wn.shape, name
        if gn.dtype == bool or np.issubdtype(gn.dtype, np.integer):
            np.testing.assert_array_equal(gn, wn, err_msg=name)
        else:
            np.testing.assert_allclose(gn, wn, rtol=r, atol=a, err_msg=name)
