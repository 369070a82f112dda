"""dy2static: AST capture of data-dependent Python control flow
(``paddle_tpu/jit/dy2static.py``).

Reference parity: python/paddle/jit/dy2static (program_translator.py:305
+ the transformer pipeline: ifelse_transformer, loop_transformer, ...).
The AST rewrites are the JAX package's, unchanged: ``if``/``while``/
``for-range`` statements become calls to runtime helpers, ``break`` /
``continue`` become guarded flags (break_continue_transformer.py), an
early ``return`` anywhere becomes a flag + return-value slot
(return_transformer.py), and ``lst.append(x)`` / ``d[k] = v`` /
``d[k] += v`` inside compound statements become functional
re-assignments (list_transformer.py), so the container rides the
carry / branch tuples like any other local.

The runtime helpers pick plain Python when the condition is concrete (an
eager tensor or a Python value) and, when it is traced (``torch.export``
or an FX / dynamo trace: a fake tensor, or any tensor while compiling),
``torch.cond`` and ``torch._higher_order_ops.while_loop`` in place of
``lax.cond`` / ``lax.while_loop``, so ONE source serves both modes.
What those two take is narrower than what lax takes, and each case they
cannot carry raises a ``TypeError`` at trace time; nothing unrolls
silently:

* every operand and carried value is a tensor: Python numbers and bools
  in a carry become 0-d tensors (int64, the default float dtype, bool),
  and a branch or body output that is its input unchanged is cloned
  (torch's higher-order ops refuse an output aliasing an input);
* a carried value other than a tensor or a Python number (a list, a
  dict, a string) raises, as does a body that changes a carried value's
  shape or dtype;
* a loop with a concrete trip count that grows a list UNROLLS, as in
  the JAX package (each iteration changes the carry's structure); a loop
  whose continuation is TRACED may not grow containers and says so.

Caveats shared with the JAX package and the reference's transformers:
the functional rewrite breaks aliasing (mutations are visible through
the rewritten NAME only); genuinely dynamic structure (data-dependent
shapes, differently-typed returns per branch, iteration over traced
non-range iterables) raises at trace time; a function DEF whose name
must escape a converted branch fails at its use site (function values
cannot ride a carry).  Nested defs used within their scope and
``try/except`` convert fine.
"""

from __future__ import annotations

import ast
import functools
import inspect
import itertools
import sys
import textwrap
import types

import torch
from torch.utils import _pytree

__all__ = ["convert_to_static", "cond_call", "while_call",
           "UNDEF", "undef_lookup"]


# ---------------------------------------------------------------- runtime

def _is_traced(x):
    """A tensor whose value the trace does not know: any tensor while
    dynamo / ``torch.export`` compiles, or a fake tensor."""
    if not isinstance(x, torch.Tensor):
        return False
    if torch.compiler.is_compiling():
        return True
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


class _Undef:
    """Sentinel for a name assigned in only one branch and unbound in
    the other (reference dy2static's UndefinedVar)."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"


UNDEF = _Undef()


def undef_lookup(thunk):
    """Read a possibly-unbound outer name: its value, or UNDEF."""
    try:
        return thunk()
    except (NameError, UnboundLocalError):
        return UNDEF


def _as_carried(tree, what):
    """A carry / operand entry as torch's control-flow ops take it: a
    pytree (list / tuple / dict) of tensors, Python numbers and bools
    made 0-d tensors; any other leaf raises."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (bool, int, float)):
            return torch.tensor(v, dtype=torch.get_default_dtype()
                                if isinstance(v, float) else None)
        raise TypeError(
            f"dy2static: a TRACED `{what}` carries a {type(v).__name__} "
            "value; torch.cond / while_loop carry tensors (and Python "
            "numbers, as 0-d tensors) in lists, tuples and dicts only: "
            "build the value from tensors, or keep the condition concrete")
    return _pytree.tree_map(leaf, tree)


def _fresh(tree):
    """Every tensor of `tree` copied: torch's higher-order ops refuse an
    output that aliases an input or another output."""
    return _pytree.tree_map(torch.clone, tree)


def _abstract(fn, probe):
    """``fn(probe)`` evaluated for its shapes only: on fake tensors,
    with no node recorded in the trace (``jax.eval_shape``'s part)."""
    from torch.fx.experimental.proxy_tensor import \
        disable_proxy_modes_tracing
    with disable_proxy_modes_tracing():
        return fn(probe)


def _zeros_of(t):
    """Zeros of `t`'s shape, dtype and device from a factory: `t` may be
    a fake tensor of an abstract run, which the trace does not know."""
    return torch.zeros(t.shape, dtype=t.dtype, device=t.device)


def cond_call(pred, true_fn, false_fn, operands, needed):
    """if-statement runtime: python branch when concrete, ``torch.cond``
    when traced.  Branch fns take the tuple of current values of every
    name the branches assign (UNDEF where unbound) and return the
    updated tuple; ``needed[i]`` marks operands whose INCOMING value
    matters (names not re-assigned by both branches)."""
    if not _is_traced(pred):
        return true_fn(operands) if bool(pred) else false_fn(operands)
    fixed = []
    for v, need in zip(operands, needed):
        if v is UNDEF:
            if need:
                raise TypeError(
                    "dy2static: a variable assigned in only one branch of "
                    "a TRACED `if` has no prior definition; initialise it "
                    "before the if so both branches agree on its type")
            # both branches overwrite it: a placeholder keeps the
            # operands valid, the incoming value is never used
            fixed.append(torch.zeros(()))
        else:
            fixed.append(v)
    if any(v is None for v in fixed):
        # None marks the not-yet-set early-return value (__jst_rv): its
        # type comes from whichever branch assigns it — evaluate the
        # branches abstractly with scalar probes, then seed a typed zeros
        # placeholder (sound: the value is only ever READ under the
        # return flag, which is False until a real assignment happened)
        probe = tuple(torch.zeros(()) if v is None else v for v in fixed)
        outs = []
        for branch in (true_fn, false_fn):
            try:
                outs.append(_abstract(branch, probe))
            except Exception:   # a branch that cannot run on the probe
                pass
        new_fixed = []
        for i, v in enumerate(fixed):
            if v is not None:
                new_fixed.append(v)
                continue
            # prefer the branch that actually ASSIGNED the slot (its
            # value differs from the scalar probe in shape or dtype: an
            # int return must not be seeded with a float placeholder)
            seed = None
            for out in outs:
                a = out[i]
                if isinstance(a, (bool, int, float)):
                    a = _as_carried(a, "if")
                if isinstance(a, torch.Tensor) and (
                        (a.shape, a.dtype) != (probe[i].shape,
                                               probe[i].dtype)
                        or len(outs) == 1):
                    seed = _zeros_of(a)
                    break
            new_fixed.append(torch.zeros(()) if seed is None else seed)
        fixed = new_fixed
    ops = tuple(_as_carried(v, "if") for v in fixed)

    def branch(fn):
        return lambda *c: _fresh(_as_carried(tuple(fn(c)), "if"))

    try:
        return tuple(torch.cond(pred, branch(true_fn), branch(false_fn),
                                ops))
    except Exception as e:
        raise TypeError(
            "dy2static: the branches of a TRACED `if` must bind the same "
            "variables with matching shapes/dtypes (early returns under a "
            "traced condition must be type-stable across paths; branches "
            "must add the same dict keys / append the same number of list "
            f"elements); torch.cond refused them: {e}") from e


def bool_not(x):
    """Traced-safe `not` (the early-exit flags may be traced)."""
    if _is_traced(x):
        return torch.logical_not(x)
    return not x


def bool_and(a, b):
    if _is_traced(a) or _is_traced(b):
        return torch.logical_and(torch.as_tensor(a), torch.as_tensor(b))
    return a and b


def bool_or(a, b):
    if _is_traced(a) or _is_traced(b):
        return torch.logical_or(torch.as_tensor(a), torch.as_tensor(b))
    return a or b


def list_append(x, y):
    """Functional ``x.append(y)`` — the rewrite target for appends inside
    converted compound statements.  Lists/tuples get a NEW container (so
    the name can ride a carry/branch tuple); anything else with a real
    .append (e.g. a TensorArray) keeps its own mutating semantics."""
    if isinstance(x, list):
        return x + [y]
    if isinstance(x, tuple):
        return x + (y,)
    if x is UNDEF:
        raise TypeError(
            "dy2static: .append() on a variable with no prior value in "
            "this path; initialise the list before the loop/branch")
    x.append(y)
    return x


def container_setitem(x, k, v):
    """Functional ``x[k] = v`` — dicts/lists become new containers;
    tensors go through their own setitem (in place)."""
    if isinstance(x, dict):
        out = dict(x)
        out[k] = v
        return out
    if isinstance(x, list):
        out = list(x)
        out[k] = v
        return out
    if x is UNDEF:
        raise TypeError(
            "dy2static: item assignment on a variable with no prior value "
            "in this path; initialise the container before the loop/branch")
    x[k] = v
    return x


def range_cont(i, stop, step):
    """Continuation test for a rewritten for-range: sign-aware."""
    if not _is_traced(step):
        return i < stop if bool(step > 0) else i > stop
    return torch.where(step > 0, i < stop, i > stop)


def _structure(carry):
    return _pytree.tree_structure(
        carry, is_leaf=lambda v: v is UNDEF or v is None)


def while_call(cond_fn, body_fn, carry, seedable=None):
    """while-statement runtime: carry is the tuple of loop variables.

    UNDEF entries are body-local temps with no pre-loop value; entries
    marked ``seedable`` (statically proven written-before-read in the
    body — e.g. a nested loop's induction/flag temps) get a typed zeros
    placeholder inferred from one abstract body evaluation; the rest
    raise loudly.  ``None`` entries are not-yet-set early-return values,
    promoted the same way."""
    first = cond_fn(carry)
    if not _is_traced(first):
        # python path while the test stays concrete; a traced `if` inside
        # the body (e.g. an early return on traced data) can inject
        # traced tensors into the carry mid-loop — hand the REMAINING
        # iterations to while_loop then instead of failing on
        # bool(tensor).  Exception: a body that GROWS the carry's
        # structure (functionalized list.append, new dict keys) must keep
        # unrolling — while_loop cannot carry a changing structure
        while True:
            c = cond_fn(carry)
            if _is_traced(c):
                break
            if not bool(c):
                return carry
            new = body_fn(carry)
            grew = _structure(new) != _structure(carry)
            carry = new
            if not grew and any(_is_traced(v)
                                for v in _pytree.tree_leaves(carry)):
                break

    if seedable is None:
        seedable = (False,) * len(carry)
    if any(v is UNDEF and not s for v, s in zip(carry, seedable)):
        raise TypeError(
            "dy2static: a TRACED `while` body introduces a variable with "
            "no pre-loop value; initialise it before the loop so the "
            "carry has a stable type")
    if any(v is UNDEF or v is None for v in carry):
        # infer placeholder types from one abstract body evaluation
        # (cond_call promotes inner Nones); sound for seedable slots —
        # their pre-loop value is never read
        probe = tuple(torch.zeros(()) if v is UNDEF else
                      v if v is None else _as_carried(v, "while")
                      for v in carry)
        try:
            outs = _abstract(body_fn, probe)
            carry = tuple(
                _zeros_of(_as_carried(a, "while"))
                if (v is None or v is UNDEF) else v
                for v, a in zip(carry, outs))
        except Exception:   # a body that cannot run on the probe
            carry = tuple(torch.zeros(()) if (v is None or v is UNDEF)
                          else v for v in carry)
    init = tuple(_as_carried(v, "while") for v in carry)

    def cond_tensor(*c):
        return torch.as_tensor(cond_fn(tuple(c)))

    def body(*c):
        out = body_fn(tuple(c))
        if _structure(out) != _structure(c):
            raise TypeError(
                "dy2static: the body of a loop with a TRACED continuation "
                "changes the carried structure (list.append / new dict "
                "keys per iteration); while_loop cannot grow its carry. "
                "Make the trip count concrete (the loop then unrolls) or "
                "preallocate a fixed-size tensor and write it by index")
        return _fresh(_as_carried(tuple(out), "while"))

    from torch._higher_order_ops.while_loop import while_loop
    try:
        return tuple(while_loop(cond_tensor, body, init))
    except TypeError:
        raise
    except Exception as e:
        raise TypeError(
            "dy2static: torch's while_loop refused the loop with a TRACED "
            "continuation (each carried tensor must keep its shape and "
            f"dtype across iterations): {e}") from e


# ------------------------------------------------------------ the rewrite

_MODULES = itertools.count()

class _Unsupported(NotImplementedError):
    pass


def _assigned_names(nodes):
    """Simple-Name store targets in a statement list (recursively)."""
    out = []

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Store) and node.id not in out:
                out.append(node.id)

        def visit_AugAssign(self, node):
            if isinstance(node.target, ast.Name) and \
                    node.target.id not in out:
                out.append(node.target.id)
            self.generic_visit(node)

        # nested defs own their scope
        def visit_FunctionDef(self, node):
            pass

        def visit_Lambda(self, node):
            pass

        # py3 comprehension targets are scoped to the comprehension — they
        # are NOT branch-local assignments (walrus escapes are not handled)
        def _skip(self, node):
            pass

        visit_ListComp = visit_SetComp = _skip
        visit_GeneratorExp = visit_DictComp = _skip

    for n in nodes:
        V().visit(n)
    return out


def _read_before_store(nodes):
    """Names Loaded before their first Store, in (approximate) execution
    order — an UNDEF placeholder for such a name could actually be read,
    so it must be treated as `needed` (loud error instead of a silent 0)."""
    stored = set()
    reads = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Load) and node.id not in stored:
                reads.add(node.id)
            elif isinstance(node.ctx, ast.Store):
                stored.add(node.id)

        def visit_Assign(self, node):  # value is evaluated before targets
            self.visit(node.value)
            for t in node.targets:
                self.visit(t)

        def visit_AugAssign(self, node):  # target is read, then written
            self.visit(node.value)
            if isinstance(node.target, ast.Name):
                if node.target.id not in stored:
                    reads.add(node.target.id)
                stored.add(node.target.id)
            else:
                self.visit(node.target)

        def visit_Call(self, node):
            # __jst_undef_lookup(lambda: name) is the transformer's OWN
            # safe read (returns UNDEF instead of raising) — not a user
            # read; skip it so already-rewritten inner ifs don't mark
            # every assigned name as read-before-store
            if isinstance(node.func, ast.Name) and \
                    node.func.id == "__jst_undef_lookup":
                return
            self.generic_visit(node)

        def _visit_comp(self, node):
            # a comprehension's generators run before its elt, and its
            # targets are scoped to it — visit in execution order with the
            # targets counting as stores (conservatively left in `stored`)
            for gen in node.generators:
                self.visit(gen.iter)
                self.visit(gen.target)
                for cond in gen.ifs:
                    self.visit(cond)
            if hasattr(node, "elt"):
                self.visit(node.elt)
            else:  # DictComp
                self.visit(node.key)
                self.visit(node.value)

        visit_ListComp = visit_SetComp = visit_GeneratorExp = _visit_comp
        visit_DictComp = _visit_comp

        def _visit_closure(self, node):
            # free variables of a nested def/lambda may be read when it is
            # called — count its Loads (minus its own args) as reads.
            # Functions the transformer itself generated (rewritten inner
            # ifs/whiles) are exempt: their reads go through the carry
            # tuple / undef_lookup machinery, not bare unbound names.
            if getattr(node, "name", "").startswith("__jst_"):
                return
            args = {a.arg for a in node.args.args + node.args.posonlyargs
                    + node.args.kwonlyargs}
            for a in (node.args.vararg, node.args.kwarg):
                if a is not None:
                    args.add(a.arg)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and \
                        isinstance(sub.ctx, ast.Load) and \
                        sub.id not in args and sub.id not in stored:
                    reads.add(sub.id)

        visit_FunctionDef = visit_AsyncFunctionDef = _visit_closure
        visit_Lambda = _visit_closure

    v = V()
    for n in nodes:
        v.visit(n)
    return reads


def _read_names(nodes):
    out = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, ast.Load):
                out.add(node.id)

    for n in nodes:
        V().visit(n)
    return out


def _check_no_flow_escape(nodes, what):
    """Break/continue/return that survived the early-exit rewrites (e.g.
    inside non-range for loops the converter leaves as python) still can't
    be functionalized — keep the loud diagnostic."""
    class V(ast.NodeVisitor):
        def visit_Return(self, node):
            raise _Unsupported(
                f"dy2static: `return` inside a converted {what} is not "
                "supported; assign to a variable and return after it")

        def visit_Break(self, node):
            raise _Unsupported(
                f"dy2static: `break` inside a converted {what} is not "
                "supported; fold the exit condition into the loop test")

        def visit_Continue(self, node):
            raise _Unsupported(
                f"dy2static: `continue` inside a converted {what} is not "
                "supported")

        def visit_FunctionDef(self, node):
            pass

    for n in nodes:
        V().visit(n)


# -- early-exit rewrites (reference: jit/dy2static's
#    break_continue_transformer.py + return_transformer.py) ------------------

def _name(n, ctx=ast.Load):
    return ast.Name(id=n, ctx=ctx())

def _assign(target, value):
    return ast.Assign(targets=[_name(target, ast.Store)], value=value)

def _call(fn, *args):
    return ast.Call(func=_name(fn), args=list(args), keywords=[])

def _not(expr):
    # traced-safe: the flags these expressions read may be traced tensors
    return _call("__jst_not", expr)

def _and(a, b):
    return _call("__jst_and", a, b)

def _or(a, b):
    return _call("__jst_or", a, b)


def _contains_here(nodes, types, *, through_loops=True):
    """Does any statement contain a node of `types`, NOT descending into
    nested function defs (and optionally not into nested loops — break /
    continue bind to the nearest loop)?"""
    found = []

    class V(ast.NodeVisitor):
        def generic_visit(self, node):
            if isinstance(node, types):
                found.append(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if not through_loops and isinstance(node, (ast.While, ast.For)):
                return
            super().generic_visit(node)

    for n in nodes:
        V().visit(n)
    return len(found) > 0


class _BreakContinueRewriter(ast.NodeTransformer):
    """Replace this loop's break/continue with flag assignments (does not
    descend into nested loops or defs — they own their own statements)."""

    def __init__(self, brk, cont):
        self.brk = brk
        self.cont = cont

    def visit_Break(self, node):
        return _assign(self.brk, ast.Constant(True))

    def visit_Continue(self, node):
        return _assign(self.cont, ast.Constant(True))

    def visit_While(self, node):
        return node  # nested loop: its breaks are its own

    def visit_For(self, node):
        return node

    def visit_FunctionDef(self, node):
        return node

    def visit_Lambda(self, node):
        return node


def _guard_tail(stmts, flag_names):
    """After any statement that may set an exit flag, wrap the REST of the
    list in `if not (flag or ...):` — recursively inside If arms, so
    post-break code never runs once a flag is up (reference
    break_continue_transformer's BreakContinueTransformer)."""
    def sets_flag(st):
        for sub in ast.walk(st):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name) and t.id in flag_names:
                        return True
        return False

    out = []
    for i, st in enumerate(stmts):
        if isinstance(st, ast.If):
            st = ast.If(test=st.test,
                        body=_guard_tail(st.body, flag_names),
                        orelse=_guard_tail(st.orelse, flag_names))
        elif isinstance(st, ast.While):
            st = ast.While(test=st.test,
                           body=_guard_tail(st.body, flag_names),
                           orelse=st.orelse)
        elif isinstance(st, ast.For):
            st = ast.For(target=st.target, iter=st.iter,
                         body=_guard_tail(st.body, flag_names),
                         orelse=st.orelse)
        out.append(st)
        if sets_flag(st):
            rest = _guard_tail(stmts[i + 1:], flag_names)
            if rest:
                cond = _name(flag_names[0])
                for fn_ in flag_names[1:]:
                    cond = _or(cond, _name(fn_))
                out.append(ast.If(test=_not(cond), body=rest, orelse=[]))
            return out
    return out


class _ContainerRewriter(ast.NodeTransformer):
    """Functionalize container mutation INSIDE compound statements
    (reference list_transformer.py / the dict-assignment handling in
    basic_api_transformer.py): ``x.append(v)`` →
    ``x = __jst_list_append(x, v)``; ``x[k] = v`` →
    ``x = __jst_setitem(x, k, v)``; ``x[k] op= v`` →
    ``x = __jst_setitem(x, k, x[k] op v)``.  Top-level statements keep
    true Python mutation semantics (they never ride a carry), which also
    bounds the aliasing caveat to converted control flow.  Slice stores
    (``x[a:b] = v``) are left alone."""

    def __init__(self):
        self._depth = 0
        self._key_uid = 0

    def _compound(self, node):
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1
        return node

    visit_If = visit_While = visit_For = _compound

    def visit_FunctionDef(self, node):
        return node  # nested defs own their scope

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node

    def visit_Expr(self, node):
        c = node.value
        if (self._depth and isinstance(c, ast.Call)
                and isinstance(c.func, ast.Attribute)
                and c.func.attr == "append"
                and isinstance(c.func.value, ast.Name)
                and len(c.args) == 1 and not c.keywords):
            n = c.func.value.id
            return ast.copy_location(
                _assign(n, _call("__jst_list_append", _name(n), c.args[0])),
                node)
        return node

    def visit_Assign(self, node):
        if (self._depth and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and not isinstance(node.targets[0].slice, ast.Slice)):
            t = node.targets[0]
            return ast.copy_location(
                _assign(t.value.id,
                        _call("__jst_setitem", _name(t.value.id), t.slice,
                              node.value)), node)
        return node

    def visit_AugAssign(self, node):
        if (self._depth and isinstance(node.target, ast.Subscript)
                and isinstance(node.target.value, ast.Name)
                and not isinstance(node.target.slice, ast.Slice)):
            t = node.target
            n = t.value.id
            # python evaluates the subscript of an augmented assignment
            # ONCE — `d[next(it)] += 1` must not consume two iterator
            # elements.  Constants and bare names are re-evaluation-safe
            # (and binding them to a temp would push a possibly-str key
            # into the loop carry, which while_loop rejects); any
            # other key expression is bound to a temp first.
            if isinstance(t.slice, (ast.Constant, ast.Name)):
                import copy as _copy
                key_load = _copy.deepcopy(t.slice)
                key_store = t.slice
                bind = []
            else:
                self._key_uid += 1
                key = f"__jst_key_{self._key_uid}"
                bind = [ast.copy_location(_assign(key, t.slice), node)]
                key_load = _name(key)
                key_store = _name(key)
            load = ast.Subscript(value=_name(n), slice=key_load,
                                 ctx=ast.Load())
            newv = ast.BinOp(left=load, op=node.op, right=node.value)
            setit = ast.copy_location(
                _assign(n, _call("__jst_setitem", _name(n), key_store,
                                 newv)), node)
            return bind + [setit]
        return node


class _ReturnRewriter(ast.NodeTransformer):
    """Function-level pass: turn every `return expr` into
    `__jst_ret = True; __jst_rv = expr`, guard following statements, and
    make every loop test include `not __jst_ret` (reference
    return_transformer.py).  Applied only when some return sits inside a
    compound statement (a plain trailing return needs nothing)."""

    RET, RV = "__jst_ret", "__jst_rv"

    def visit_Return(self, node):
        # rv BEFORE the flag: _guard_tail guards everything after the
        # first flag-set statement, and the value assignment must not be
        # swallowed by its own guard
        value = node.value if node.value is not None else ast.Constant(None)
        return [_assign(self.RV, value),
                _assign(self.RET, ast.Constant(True))]

    def visit_FunctionDef(self, node):
        return node  # nested defs own their returns

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        return node


def _rewrite_returns(fdef):
    """Apply the return rewrite when any return is non-trivially placed."""
    nested = any(
        _contains_here([st], (ast.Return,))
        for st in fdef.body
        if isinstance(st, (ast.If, ast.While, ast.For, ast.Try, ast.With)))
    if not nested:
        return
    rw = _ReturnRewriter()
    fdef.body = [rw.visit(st) for st in fdef.body]
    # flatten lists the Return rewrite produced
    flat = []
    for st in fdef.body:
        flat.extend(st if isinstance(st, list) else [st])
    body = _guard_tail(flat, [_ReturnRewriter.RET])
    prologue = [_assign(_ReturnRewriter.RET, ast.Constant(False)),
                _assign(_ReturnRewriter.RV, ast.Constant(None))]
    fdef.body = prologue + body + [
        ast.Return(value=_name(_ReturnRewriter.RV))]


def _rewrite_break_continue(node, uid):
    """Rewrite a While body's break/continue into guarded flags; returns
    (init_stmts, new_body, new_test)."""
    has_brk = _contains_here(node.body, (ast.Break,), through_loops=False)
    has_cont = _contains_here(node.body, (ast.Continue,),
                              through_loops=False)
    if not (has_brk or has_cont):
        return [], node.body, node.test
    brk = f"__jst_brk_{uid}"
    cont = f"__jst_cont_{uid}"
    rw = _BreakContinueRewriter(brk, cont)
    body = []
    for st in node.body:
        new = rw.visit(st)
        body.extend(new if isinstance(new, list) else [new])
    flags = [f for f, used in ((brk, True), (cont, has_cont)) if used]
    body = _guard_tail(body, flags)
    # both flags need PRE-loop values too: they ride the while carry, and
    # a traced while_loop needs a stable carry type from iteration zero
    init = [_assign(brk, ast.Constant(False))]
    prologue = []
    if has_cont:
        init.append(_assign(cont, ast.Constant(False)))
        prologue = [_assign(cont, ast.Constant(False))]
    test = _and(node.test, _not(_name(brk)))
    return init, prologue + body, test


def _names_tuple(names, ctx):
    return ast.Tuple(elts=[ast.Name(id=n, ctx=ctx()) for n in names],
                     ctx=ctx())


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self._uid = 0

    def _fresh(self, base):
        self._uid += 1
        return f"__jst_{base}_{self._uid}"

    # -- if -> cond_call -----------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        assigned = _assigned_names(node.body + node.orelse)
        if not assigned:
            return node  # side-effect-free on locals: keep as-is (eager
            # semantics; traced conditions without assignment are rare).
            # NOTE a def/class statement in such a branch stays plain
            # Python too: fine under a concrete condition; under a traced
            # one the generic data-dependent bool() error surfaces.  A def
            # whose NAME is read after a CONVERTED if fails at the use
            # site with NameError — function values cannot ride a
            # torch.cond carry; define variants before the if instead.
        _check_no_flow_escape(node.body + node.orelse, "if")
        tname = self._fresh("true")
        fname = self._fresh("false")
        t_assigned = set(_assigned_names(node.body))
        f_assigned = set(_assigned_names(node.orelse))
        carry_name = self._fresh("ifcarry")

        # branch fns receive the current values of every assigned name as
        # a tuple (read-then-write names would otherwise hit python's
        # local-shadowing UnboundLocalError inside the nested function)
        unpack = ast.Assign(
            targets=[_names_tuple(assigned, ast.Store)],
            value=ast.Name(id=carry_name, ctx=ast.Load()))
        ret = ast.Return(value=_names_tuple(assigned, ast.Load))
        true_def = ast.FunctionDef(
            name=tname, args=_onearg(carry_name),
            body=[unpack] + node.body + [ret], decorator_list=[])
        false_body = [unpack] + (node.orelse or [ast.Pass()]) + [ret]
        false_def = ast.FunctionDef(
            name=fname, args=_onearg(carry_name), body=false_body,
            decorator_list=[])
        # operand tuple: outer value of each name, or UNDEF when unbound
        operands = ast.Tuple(
            elts=[ast.Call(
                func=ast.Name(id="__jst_undef_lookup", ctx=ast.Load()),
                args=[ast.Lambda(args=_noargs(),
                                 body=ast.Name(id=n, ctx=ast.Load()))],
                keywords=[]) for n in assigned],
            ctx=ast.Load())
        # a name's incoming value matters when some branch might not write
        # it, OR when a branch reads it before its first store in that
        # branch (an UNDEF placeholder could then be silently computed on)
        rbs = _read_before_store(node.body) | _read_before_store(node.orelse)
        needed = ast.Tuple(
            elts=[ast.Constant(not (n in t_assigned and n in f_assigned)
                               or n in rbs)
                  for n in assigned],
            ctx=ast.Load())
        call = ast.Assign(
            targets=[_names_tuple(assigned, ast.Store)],
            value=ast.Call(
                func=ast.Name(id="__jst_cond_call", ctx=ast.Load()),
                args=[node.test, ast.Name(id=tname, ctx=ast.Load()),
                      ast.Name(id=fname, ctx=ast.Load()), operands,
                      needed],
                keywords=[]))
        out = [true_def, false_def, call]
        # restore python unbound semantics: a name that came back UNDEF
        # (one-armed if on the untaken path, nothing outer) is deleted
        for n in assigned:
            if n not in t_assigned or n not in f_assigned:
                out.append(ast.If(
                    test=ast.Compare(
                        left=ast.Name(id=n, ctx=ast.Load()),
                        ops=[ast.Is()],
                        comparators=[ast.Name(id="__jst_UNDEF",
                                              ctx=ast.Load())]),
                    body=[ast.Delete(targets=[
                        ast.Name(id=n, ctx=ast.Del())])],
                    orelse=[]))
        return out

    # -- while -> while_call -------------------------------------------------
    def visit_While(self, node):
        if node.orelse:
            raise _Unsupported("dy2static: while/else is not supported")
        # a body that can set the early-return flag must stop the loop —
        # applied HERE (not in _ReturnRewriter) so for-range loops, which
        # only become While at conversion time, get the same exit test
        ret = _ReturnRewriter.RET
        if any(isinstance(sub, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == ret
                for t in sub.targets)
               for st in node.body for sub in ast.walk(st)):
            node = ast.While(test=_and(node.test, _not(_name(ret))),
                             body=node.body, orelse=node.orelse)
        # rewrite THIS loop's break/continue into guarded flags before
        # any conversion (reference break_continue_transformer.py); the
        # guard ifs it introduces are then converted like user ifs
        self._uid += 1
        bc_init, bc_body, bc_test = _rewrite_break_continue(node, self._uid)
        node = ast.While(test=bc_test, body=bc_body, orelse=[])
        self.generic_visit(node)
        _check_no_flow_escape(node.body, "while")
        # carry = every var the body assigns (the test reads them through
        # the carry, not a stale closure)
        carried = _assigned_names(node.body)
        if not carried:
            return bc_init + [node] if bc_init else node
        carry_name = self._fresh("carry")
        unpack = ast.Assign(
            targets=[_names_tuple(carried, ast.Store)],
            value=ast.Name(id=carry_name, ctx=ast.Load()))
        cname = self._fresh("while_cond")
        bname = self._fresh("while_body")
        cond_def = ast.FunctionDef(
            name=cname, args=_onearg(carry_name),
            body=[unpack, ast.Return(value=node.test)],
            decorator_list=[])
        body_def = ast.FunctionDef(
            name=bname, args=_onearg(carry_name),
            body=[unpack] + node.body
            + [ast.Return(value=_names_tuple(carried, ast.Load))],
            decorator_list=[])
        init_carry = ast.Tuple(
            elts=[ast.Call(
                func=ast.Name(id="__jst_undef_lookup", ctx=ast.Load()),
                args=[ast.Lambda(args=_noargs(),
                                 body=ast.Name(id=n, ctx=ast.Load()))],
                keywords=[]) for n in carried],
            ctx=ast.Load())
        # a carried name written before any read in the body never needs
        # its pre-loop value — mark it seedable so while_call can give a
        # typed placeholder when it is unbound at loop entry (nested
        # loops' induction/flag temps live in the enclosing body)
        rbs = _read_before_store(node.body)
        seedable = ast.Tuple(
            elts=[ast.Constant(n not in rbs) for n in carried],
            ctx=ast.Load())
        call = ast.Assign(
            targets=[_names_tuple(carried, ast.Store)],
            value=ast.Call(
                func=ast.Name(id="__jst_while_call", ctx=ast.Load()),
                args=[ast.Name(id=cname, ctx=ast.Load()),
                      ast.Name(id=bname, ctx=ast.Load()),
                      init_carry, seedable],
                keywords=[]))
        return bc_init + [cond_def, body_def, call]

    # -- for i in range(...) -> while ---------------------------------------
    def visit_For(self, node):
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and isinstance(node.target, ast.Name))
        if not is_range or node.orelse:
            self.generic_visit(node)
            return node  # non-range iteration stays Python (unrolled
            # under trace — reference does the same for non-tensor iters)
        i = node.target.id
        rargs = node.iter.args
        if len(rargs) == 1:
            start, stop, step = ast.Constant(0), rargs[0], ast.Constant(1)
        elif len(rargs) == 2:
            start, stop, step = rargs[0], rargs[1], ast.Constant(1)
        else:
            start, stop, step = rargs
        stop_name = self._fresh("stop")
        step_name = self._fresh("step")
        init = [
            ast.Assign(targets=[ast.Name(id=i, ctx=ast.Store())],
                       value=start),
            ast.Assign(targets=[ast.Name(id=stop_name, ctx=ast.Store())],
                       value=stop),
            ast.Assign(targets=[ast.Name(id=step_name, ctx=ast.Store())],
                       value=step),
        ]
        test = ast.Call(
            func=ast.Name(id="__jst_range_cont", ctx=ast.Load()),
            args=[ast.Name(id=i, ctx=ast.Load()),
                  ast.Name(id=stop_name, ctx=ast.Load()),
                  ast.Name(id=step_name, ctx=ast.Load())],
            keywords=[])
        # `i = i + step`, not `i += step`: a traced index is a tensor,
        # which `+=` would update in place (while_loop refuses an input
        # mutated in its body); the JAX package writes `+=` on immutable
        # arrays
        incr = ast.Assign(
            targets=[ast.Name(id=i, ctx=ast.Store())],
            value=ast.BinOp(left=ast.Name(id=i, ctx=ast.Load()),
                            op=ast.Add(),
                            right=ast.Name(id=step_name, ctx=ast.Load())))
        # rewrite break/continue against THIS loop before appending the
        # increment: `continue` must skip the rest of the body but still
        # advance the induction variable (python range semantics)
        self._uid += 1
        bc_init, bc_body, bc_test = _rewrite_break_continue(
            ast.While(test=test, body=node.body, orelse=[]), self._uid)
        loop = ast.While(test=bc_test, body=bc_body + [incr], orelse=[])
        for n in init:
            ast.copy_location(n, node)
        ast.copy_location(loop, node)
        ast.fix_missing_locations(loop)
        rewritten = self.visit_While(loop)
        out = list(init) + list(bc_init)
        out.extend(rewritten if isinstance(rewritten, list) else [rewritten])
        return out


def _noargs():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _onearg(name):
    return ast.arguments(posonlyargs=[], args=[ast.arg(arg=name)],
                         vararg=None, kwonlyargs=[], kw_defaults=[],
                         kwarg=None, defaults=[])


def convert_to_static(fn):
    """AST-rewrite fn's data-dependent control flow (reference
    StaticFunction's transformer pipeline).  Returns the rewritten
    function, or fn unchanged when no source is available (lambdas,
    builtins, C functions)."""
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        return fn
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return fn
    # drop decorators (they already ran to produce this call)
    fdef.decorator_list = []
    # returns nested in compound statements become flag+value assignments
    # (reference return_transformer.py) BEFORE control-flow conversion, so
    # the introduced guards convert like user ifs
    _rewrite_returns(fdef)
    # container mutations inside compounds become functional re-assigns
    # BEFORE control-flow conversion, so containers join branch/loop
    # carries like any assigned name (applied to the BODY — the
    # transformer's visit_FunctionDef guard is for nested defs)
    _crw = _ContainerRewriter()
    fdef.body = [_crw.visit(st) for st in fdef.body]
    ast.fix_missing_locations(fdef)
    new = _ControlFlowTransformer().visit(tree)
    ast.fix_missing_locations(new)

    glb = dict(fn.__globals__)
    glb["__jst_cond_call"] = cond_call
    glb["__jst_while_call"] = while_call
    glb["__jst_undef_lookup"] = undef_lookup
    glb["__jst_UNDEF"] = UNDEF
    glb["__jst_range_cont"] = range_cont
    glb["__jst_not"] = bool_not
    glb["__jst_and"] = bool_and
    glb["__jst_or"] = bool_or
    glb["__jst_list_append"] = list_append
    glb["__jst_setitem"] = container_setitem
    # snapshot closure cells (the recompiled fn has no closure)
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                glb.setdefault(name, cell.cell_contents)
            except ValueError:
                pass  # not-yet-filled cell (e.g. the fn's own recursion)
    code = compile(new, filename=f"<dy2static {fn.__name__}>", mode="exec")
    # the globals are a module of their own, registered by name: dynamo
    # (which traces torch.cond / while_loop's bodies) guards a global
    # through the module its function's `__name__` imports
    mod = types.ModuleType(f"_dy2static_{next(_MODULES)}_{fn.__name__}")
    mod.__dict__.update(glb)
    mod.__dict__["__name__"] = mod.__name__
    sys.modules[mod.__name__] = mod
    ns = {}
    exec(code, mod.__dict__, ns)  # noqa: S102 — user's own source
    out = ns[fdef.name]
    out.__wrapped_original__ = fn
    return functools.wraps(fn)(out)
