"""dy2static of the port against the JAX package's on the CPU: the cases
of ``tests/test_dy2static.py``, each written once, generically over the
two array types, and run through both packages' ``convert_to_static``:
JAX's under ``jax.jit`` (``lax.cond`` / ``lax.while_loop``), the port's
eagerly (its ``to_static`` runs the converted body on the caller's
device).  Outputs agree within 1e-6 relative (fp32).  Then the cases
whose control flow is data-dependent go through ``torch.export``: the
graph holds ``torch.cond`` / ``while_loop`` and its output equals the
eager call's; the cases torch's ops cannot carry raise a ``TypeError``
at trace time, as JAX's do."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.jit.dy2static import convert_to_static as jconvert

import paddle_tpu_torch as tp
from paddle_tpu_torch.jit import to_static
from paddle_tpu_torch.jit.dy2static import convert_to_static


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


# -- the cases (one source for both array types) ----------------------------

def if_traced(x):
    if x.sum() > 0:
        y = x * 2.0
    else:
        y = x - 1.0
    return y


def if_partial(x):
    y = x * 0.0
    if x.sum() > 0:
        y = x + 10.0
    return y


def if_nested(x):
    if x.sum() > 0:
        if x.sum() > 10:
            y = x * 3.0
        else:
            y = x * 2.0
    else:
        y = -x
    return y


def if_one_armed_new_local(x):
    if x.shape[0] > 2:
        big = x.sum() * 0.0 + 1.0  # noqa: F841
    y = x * 2
    return y


def if_comprehension(x):
    if x.sum() > 0:
        ys = sum([i * 1.0 for i in range(3)])
    else:
        ys = 0.0
    return x.sum() + ys


def if_read_outer(x):
    y = x.sum()
    if x.shape[0] > 1:
        y = y + 1.0
    else:
        y = y - 1.0
    return y


def return_inside_assigning_if(x):
    if x.sum() > 0:
        y = x * 2
        return y
    else:
        y = -x
    return y


def guard_return(x, flag):
    if flag:
        return x * 2
    return -x


def while_counter(x):
    n = 0
    while x.sum() > 1.0:
        x = x * 0.5
        n = n + 1
    return n


def while_sum(x):
    while x.sum() > 1.0:
        x = x * 0.5
    return x.sum()


def while_break(x):
    while x.sum() > 0:
        x = x - 1
        break
    return x


def for_bound(x, steps):
    acc = x * 0.0
    for i in range(steps):
        acc = acc + x * (i + 1)
    return acc


def for_iterable(x):
    for w in [1.0, 2.0, 3.0]:
        x = x * w
    return x


def lambda_free(x):
    return x * 2


def for_negative_step(x, n):
    acc = x * 0.0
    for i in range(n, 0, -1):
        acc = acc + i
    return acc


def while_local_temp(x):
    while x.sum() > 1.0:
        t = x * 0.5
        x = t
    return x


def while_break_concrete(x):
    i = 0
    while i < 10:
        x = x + 1.0
        i = i + 1
        if i >= 3:
            break
    return x


def while_continue_concrete(x):
    i = 0
    while i < 6:
        i = i + 1
        if i % 2 == 0:
            continue
        x = x + 1.0
    return x


def for_range_break(x):
    for i in range(10):
        if i == 4:
            break
        x = x + 1.0
    return x


def for_range_continue(x):
    for i in range(6):
        if i % 2 == 1:
            continue
        x = x + 1.0
    return x


def while_break_on_data(x):
    i = 0.0
    while i < 100.0:
        x = x - 0.5
        i = i + 1.0
        if x.sum() < 0:
            break
    return x


def return_from_loop(x):
    for i in range(10):
        x = x + 1.0
        if i == 2:
            return x
    return x - 100.0


def return_both_arms(x):
    if x.sum() > 0:
        return x * 2.0
    else:
        return -x


def code_after_return(x):
    if x.shape[0] > 1:
        return x + 1.0
    x = x * 100.0
    return x


def multi_target(x):
    if x.sum() > 0:
        a, b = x * 2.0, x * 3.0
    else:
        a, b = -x, x
    return a + b


def nested_loop_break(x):
    for i in range(3):
        for j in range(5):
            if j == 1:
                break
            x = x + 1.0
    return x


def return_first_match(x):
    for i in range(8):
        if x[i] > 0:
            return x[i] * (i + 1.0)
    return x[0] * 0.0


def scalar_int_return(x):
    if x.sum() > 0:
        return 1
    return 2


def break_traced_while(x, n):
    i = 0
    while i < n:
        x = x + 1
        i = i + 1
        if x.sum() > 10:
            break
    return x


def continue_in_for(x, n):
    acc = x * 0
    for i in range(n):
        if i % 2 == 0:
            continue
        acc = acc + i
    return acc


def mixed_continue_break(x, n):
    total = x * 0
    for i in range(n):
        if i == 1:
            continue
        if i >= 4:
            break
        total = total + i
    return total


def early_return_traced_for(x, n):
    for i in range(n):
        x = x + 1
        if x.sum() > 5:
            return x * 100
    return x


def return_inside_while(x):
    while x.sum() < 100:
        x = x * 2
        if x.sum() > 50:
            return x + 0.5
    return x


def tuple_aug_assign(x, flag):
    a, b = x, x * 2
    if flag.sum() > 0:
        a += 1
        a, b = b, a
    return a + b


def list_append_loop(x):
    acc = []
    for i in range(4):
        acc.append(x * (i + 1))
    return acc


def list_append_traced_if(x):
    acc = [x]
    if x.sum() > 0:
        acc.append(x * 2)
    else:
        acc.append(x - 1)
    return acc[0] + acc[1]


def dict_state_loop(x):
    state = {"sum": x * 0.0, "count": 0}
    for i in range(5):
        state["sum"] = state["sum"] + x
        state["count"] += 1
    return state["sum"] / state["count"]


def dict_state_traced_while(x):
    state = {"acc": x * 0.0, "i": 0.0}
    while state["acc"].sum() < 10.0:
        state["acc"] = state["acc"] + x
        state["i"] += 1.0
    return state["i"]


def list_setitem_branch(x):
    slots = [x * 0.0, x * 0.0]
    if x.sum() > 0:
        slots[0] = x
    else:
        slots[1] = x
    return slots[0] - slots[1]


def nested_def(x):
    def scale(v, k):
        return v * k
    out = x
    if x.sum() > 0:
        out = scale(x, 2.0)
    else:
        out = scale(x, -1.0)
    return out


def try_except_if(x):
    try:
        y = x / (x.sum() + 1.0)
    except ZeroDivisionError:
        y = x
    if y.sum() > 0:
        y = y * 2
    return y


def return_in_try(x):
    if x.sum() > 0:
        try:
            return x * 2
        except ValueError:
            return x
    return x - 1


def try_in_while(x):
    acc = x * 0.0
    while acc.sum() < 10.0:
        try:
            acc = acc + x
        except RuntimeError:
            break
    return acc


def def_inside_concrete(x, flag=True):
    out = x
    if flag:
        def twice(v):
            return v * 2
        out = twice(x)
    return out


def _a(*v):
    return np.asarray(v, np.float32)


ONES3, ONES2 = _a(1, 1, 1), _a(1, 1)
FIRST = np.zeros(8, np.float32)
FIRST[[2, 5]] = 1.0

# (function, argument tuples): numpy arrays become jax / torch arrays,
# Python values stay Python values
CASES = [
    (if_traced, [(ONES3,), (-ONES3,)]),
    (if_partial, [(ONES2,), (-ONES2,)]),
    (if_nested, [(_a(8, 8),), (ONES2,), (-ONES2,)]),
    (if_one_armed_new_local, [(np.ones((1, 3), np.float32),),
                              (np.ones((4, 3), np.float32),)]),
    (if_comprehension, [(ONES3,)]),
    (if_read_outer, [(ONES3,)]),
    (return_inside_assigning_if, [(ONES2,), (-ONES2,)]),
    (guard_return, [(ONES2, True), (ONES2, False)]),
    (while_counter, [(_a(8, 8, 8, 8),)]),
    (while_sum, [(_a(4, 4),)]),
    (while_break, [(ONES2,)]),
    (for_bound, [(ONES2, 3), (ONES2, 5)]),
    (for_iterable, [(ONES2,)]),
    (lambda_free, [(ONES2,)]),
    (for_negative_step, [(_a(0), 3)]),
    (while_local_temp, [(_a(4, 4),)]),
    (while_break_concrete, [(_a(0, 0),)]),
    (while_continue_concrete, [(_a(0, 0),)]),
    (for_range_break, [(_a(0, 0),)]),
    (for_range_continue, [(_a(0, 0),)]),
    (while_break_on_data, [(ONES2,)]),
    (return_from_loop, [(_a(0, 0),)]),
    (return_both_arms, [(ONES3,), (-ONES3,)]),
    (code_after_return, [(_a(0, 0),), (_a(0),)]),
    (multi_target, [(ONES2,), (-ONES2,)]),
    (nested_loop_break, [(_a(0, 0),)]),
    (return_first_match, [(FIRST,)]),
    (scalar_int_return, [(ONES3,), (-ONES3,)]),
    (break_traced_while, [(np.ones(4, np.float32), 20)]),
    (continue_in_for, [(np.float32(0), 6)]),
    (mixed_continue_break, [(np.float32(0), 10)]),
    (early_return_traced_for, [(ONES2, 10)]),
    (return_inside_while, [(ONES3,)]),
    (tuple_aug_assign, [(np.float32(1), ONES2), (np.float32(1), -ONES2)]),
    (list_append_loop, [(ONES3,)]),
    (list_append_traced_if, [(ONES3,), (-ONES3,)]),
    (dict_state_loop, [(_a(3, 3),)]),
    (dict_state_traced_while, [(_a(1, 1),)]),
    (list_setitem_branch, [(ONES2,), (-ONES2,)]),
    (nested_def, [(ONES3,), (-ONES3,)]),
    (try_except_if, [(ONES2,)]),
    (return_in_try, [(ONES2,), (-ONES2,)]),
    (try_in_while, [(_a(1, 1),)]),
    (def_inside_concrete, [(ONES3,)]),
]


def _jax(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _torch(v):
    return torch.from_numpy(np.array(v)) if isinstance(v, (np.ndarray,
                                                           np.floating)) \
        else v


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [np.asarray(o, np.float64) for o in out]
    return [np.asarray(out, np.float64)]


def _run_jax(fn, args):
    """JAX's to_static path: the converted function under jax.jit (Python
    flags and callables stay static)."""
    static = [i for i, a in enumerate(args) if isinstance(a, bool)]
    conv = jconvert(fn)
    out = jax.jit(conv, static_argnums=static)(*map(_jax, args))
    return _leaves(jax.tree.map(np.asarray, out))


@pytest.mark.parametrize("fn,argsets", CASES, ids=[c[0].__name__
                                                   for c in CASES])
def test_eager_port_equals_jaxs_to_static(fn, argsets):
    port = to_static(fn)
    for args in argsets:
        want = _run_jax(fn, args)
        got = port(*map(_torch, args))
        got = _leaves([t.numpy() if torch.is_tensor(t) else t
                       for t in (got if isinstance(got, list) else [got])])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_python_semantics_preserved():
    """Concrete data: the same source behaves like plain Python, in
    both packages (container rewrites and the name-scoped aliasing)."""
    def f(x):
        acc = []
        d = {}
        for i in range(3):
            acc.append(i * x)
            d[i] = i
        return acc, d

    def g(x):
        acc = []
        acc.append(x)
        for i in range(2):
            acc.append(x + i)
        return len(acc)

    for conv in (jconvert, convert_to_static):
        assert conv(f)(2.0) == ([0.0, 2.0, 4.0], {0: 0, 1: 1, 2: 2})
        assert conv(g)(1.0) == 3


def test_unbound_reads_raise_as_in_python():
    def f(x):
        if x.shape[0] > 2:
            big = x.sum()
        return big  # noqa: F821 — unbound when the branch is not taken

    for conv, arr in ((jconvert, jnp.ones((1, 3))),
                      (convert_to_static, torch.ones(1, 3))):
        with pytest.raises((NameError, UnboundLocalError)):
            conv(f)(arr)


def test_def_escaping_a_converted_branch_fails_at_use():
    def f(x):
        if x.sum() > 0:
            y = 1.0

            def op(v):
                return v * 2
        else:
            y = 2.0

            def op(v):
                return v - 1
        return op(x) + y

    with pytest.raises((NameError, NotImplementedError)):
        jax.jit(jconvert(f))(jnp.ones(3))
    with pytest.raises((NameError, NotImplementedError)):
        convert_to_static(f)(torch.ones(3))


# -- torch.export: the traced conditions -------------------------------------

class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _tensor_args(args):
    return tuple(torch.from_numpy(np.array(a)) if isinstance(
        a, (np.ndarray, np.floating)) else torch.tensor(a) for a in args)


def _hops(ep):
    """The higher-order ops of the program, its branch and body graphs
    included."""
    return sorted({n.target.name() for gm in ep.graph_module.modules()
                   if isinstance(gm, torch.fx.GraphModule)
                   for n in gm.graph.nodes
                   if isinstance(n.target, torch._ops.HigherOrderOperator)})


EXPORTED = {
    "if_traced": ["cond"], "if_partial": ["cond"], "if_nested": ["cond"],
    "return_inside_assigning_if": ["cond"], "return_both_arms": ["cond"],
    "multi_target": ["cond"], "scalar_int_return": ["cond"],
    "list_append_traced_if": ["cond"], "list_setitem_branch": ["cond"],
    "nested_def": ["cond"], "try_except_if": ["cond"],
    "return_in_try": ["cond"],
    "while_counter": ["while_loop"], "while_sum": ["while_loop"],
    "while_local_temp": ["while_loop"], "try_in_while": ["while_loop"],
    "while_break": ["while_loop"],
    "while_break_on_data": ["cond", "while_loop"],
    "return_inside_while": ["cond", "while_loop"],
    "break_traced_while": ["cond", "while_loop"],
    "continue_in_for": ["cond", "while_loop"],
    "mixed_continue_break": ["cond", "while_loop"],
    "early_return_traced_for": ["cond", "while_loop"],
}


@pytest.mark.parametrize("name", sorted(EXPORTED))
def test_export_holds_cond_and_while_loop(name):
    fn, argsets = next(c for c in CASES if c[0].__name__ == name)
    conv = convert_to_static(fn)
    for args in argsets:
        targs = _tensor_args(args)
        ep = torch.export.export(_Fn(conv), targs)
        assert set(EXPORTED[name]) <= set(_hops(ep)), _hops(ep)
        got = ep.module()(*targs)
        want = conv(*targs)
        for g, w in zip(_leaves([got]), _leaves([torch.as_tensor(want)])):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_export_refuses_what_while_loop_cannot_carry():
    """A list grown under a traced continuation and an unbound read under
    a traced `if` raise TypeErrors at trace time, as JAX's do; so does an
    in-place update of a carried tensor."""
    def grow(x):
        acc = []
        while x.sum() < 10.0:
            acc.append(x)
            x = x + 1.0
        return x

    def unbound(x):
        if x.sum() > 0:
            y = y + x.sum()  # noqa: F821 — deliberate unbound read
        else:
            y = x.sum()
        return y

    with pytest.raises(TypeError, match="grow|structure|append"):
        jax.jit(jconvert(grow))(jnp.zeros(2))
    with pytest.raises(TypeError, match="grow|structure|append|list"):
        torch.export.export(_Fn(convert_to_static(grow)), (torch.zeros(2),))
    with pytest.raises(TypeError, match="no prior definition"):
        jax.jit(jconvert(unbound))(jnp.ones(3))
    with pytest.raises(TypeError, match="no prior definition"):
        torch.export.export(_Fn(convert_to_static(unbound)),
                            (torch.ones(3),))
    # `a += 1` on a tensor updates it in place (torch's semantics, where
    # JAX rebinds an immutable array): torch.cond refuses the mutation
    with pytest.raises(TypeError, match="mutation"):
        torch.export.export(_Fn(convert_to_static(tuple_aug_assign)),
                            (torch.ones(()), torch.ones(2)))


def test_to_static_applies_input_spec_and_refuses_options():
    from paddle_tpu_torch.jit import InputSpec
    f = to_static(if_traced, input_spec=[InputSpec([None, 3], "float64")])
    out = f(np.ones((2, 3), np.float32))
    assert out.dtype == torch.float64 and f.__wrapped__ is not if_traced
    with pytest.raises(ValueError, match="dim 1 is 4"):
        f(np.ones((2, 4)))
    with pytest.raises(ValueError, match="rank"):
        f(np.ones(3))
    with pytest.raises(NotImplementedError, match="item 10"):
        to_static(if_traced, analyze="warn")
    with pytest.raises(NotImplementedError, match="item 8"):
        to_static(if_traced, shardings={})
    assert isinstance(tp.jit.to_static, type(to_static))
