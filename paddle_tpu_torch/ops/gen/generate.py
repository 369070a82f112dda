"""Op codegen: ops.yaml -> ../generated_math.py
(``paddle_tpu/ops/gen/generate.py``).

The port keeps its own copy of the JAX package's op schema
(``ops.yaml`` here): the same 304 entries with the same ``op``,
``args``, ``attrs`` and defaults, ``sharding``, ``doc``, ``oracle`` and
``test``, and a torch ``impl``.  Each entry yields one op on the hook
(``core/dispatch.py``'s ``eager_op``) with the JAX signature, its
docstring, an ``OP_INFO`` record and an ``OP_TESTS`` record (the
entry's test spec, for runs without the yaml).  Torch's autograd supplies every
gradient but those of the entries with a ``vjp`` (grad expressions over
the args, ``out`` and ``g``), which become ``torch.autograd.Function``s
saving only the residuals their backward reads.

Run:  python -m paddle_tpu_torch.ops.gen.generate
The output file is checked in; a test holds it in sync with the yaml.
"""

from __future__ import annotations

import os
import re

import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
YAML_PATH = os.path.join(HERE, "ops.yaml")
OUT_PATH = os.path.join(HERE, os.pardir, "generated_math.py")

HEADER = '''\
"""GENERATED by paddle_tpu_torch/ops/gen/generate.py from ops.yaml — DO NOT
EDIT.

The port's counterpart of ``paddle_tpu/ops/generated_math.py``: one op
on the hook a schema entry, torch's autograd for the gradients but the
custom-VJP entries' ``torch.autograd.Function``s.
Regenerate with:  python -m paddle_tpu_torch.ops.gen.generate
"""

from __future__ import annotations

import builtins  # op names shadow builtins (abs/max/min/...) — impls
                 # needing the python originals go through builtins.*
import math

import torch

from paddle_tpu_torch.core.dispatch import eager_op


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """The reduction's dims: every dim for None."""
    if axis is None:
        return tuple(range(x.ndim))
    ax = _axis(axis)
    return ax if isinstance(ax, tuple) else (ax,)


def _dt(dtype):
    if dtype is None:
        return None
    from paddle_tpu_torch.core.dtypes import to_torch
    return to_torch(dtype)


def _dev():
    """Where an op with no tensor input puts its output: the port's
    default device (``device.set_device``)."""
    from paddle_tpu_torch.core.state import resolve_device
    return resolve_device(None)


def _f(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _split(x, sections, axis):
    return torch.tensor_split(x, sections, dim=axis)


def _take(x, index, axis):
    """``jnp.take(x, index, axis)``: any index shape."""
    index = torch.as_tensor(index, device=x.device)
    axis = axis % x.ndim
    out = torch.index_select(x, axis, index.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


def _argsort(x, axis, descending, stable=True):
    """JAX's tie order: stable keeps equal keys in input order both
    ways; an unstable descending sort is the stable ascending one
    reversed."""
    if stable or not descending:
        return torch.argsort(x, dim=axis, descending=descending, stable=True)
    return torch.flip(torch.argsort(x, dim=axis, stable=True), (axis,))


def _topk(x, k, largest):
    """``lax.top_k`` over the last dim: among equal values the lower
    index first (a stable sort; ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def _quantile(x, q, axis, keepdim, method, fn):
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    ax = _axis(axis)
    if ax is None and keepdim:
        ax = tuple(range(x.ndim))
    if ax is None or isinstance(ax, int):
        return fn(x, qt, dim=ax, keepdim=bool(keepdim),
                  interpolation=method)
    nd = x.ndim
    ax = tuple(sorted(a % nd for a in ax))
    rest = [d for d in range(nd) if d not in ax]
    moved = x.permute(rest + list(ax)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = fn(moved, qt, dim=-1, keepdim=False, interpolation=method)
    if keepdim:
        for a in ax:
            out = out.unsqueeze(a + (1 if qt.ndim else 0))
    return out


def _cumext(x, axis, fn):
    """cummax / cummin with JAX's indices: the last position holding the
    running extreme."""
    xs = torch.reshape(x, (-1,)) if axis is None else x
    ax = (-1 if axis is None else int(axis)) % xs.ndim
    vals = fn(xs, ax).values
    n = xs.shape[ax]
    shape = [1] * xs.ndim
    shape[ax] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    idx = torch.where(xs == vals, pos, torch.zeros_like(pos))
    return vals, torch.cummax(idx, ax).values


def _strided(x, axis, start, end, step):
    """``x[start:end:step]`` along `axis`, negative steps included."""
    if step > 0:
        sl = [builtins.slice(None)] * x.ndim
        sl[axis] = builtins.slice(start, end, step)
        return x[tuple(sl)]
    idx = list(range(x.shape[axis]))[start:end:step]
    return torch.index_select(
        x, axis, torch.tensor(idx, dtype=torch.long, device=x.device))

'''


def _sig(entry):
    parts = list(entry["args"])
    for attr in entry.get("attrs", []) or []:
        if attr.get("required"):
            parts.append(attr["name"])
        else:
            parts.append(f"{attr['name']}={attr['default']}")
    return ", ".join(parts)


def gen_op(entry):
    name = entry["op"]
    args = entry["args"]
    sig = _sig(entry)
    impl = entry["impl"].strip()
    lines = []
    body = [f"def _{name}_pure({sig}):"]
    if "\n" in impl:
        for ln in impl.splitlines():
            body.append(f"    {ln}" if ln else "")
    elif impl.startswith("return "):
        body.append(f"    {impl}")
    else:
        body.append(f"    return {impl}")
    lines.append("\n".join(body))

    vjp = entry.get("vjp")
    core = f"_{name}_pure"
    if vjp:
        if entry.get("attrs"):
            raise ValueError(f"{name}: custom vjp only for tensor-arg ops")
        # save only the residuals the backward expressions actually read
        used = set()
        for g_expr in vjp:
            toks = set(re.findall(r"\b\w+\b", g_expr))
            used |= {a for a in args + ["out"] if a in toks}
        res_names = [a for a in args + ["out"] if a in used] or [args[0]]
        res = ", ".join(res_names) + ("," if len(res_names) == 1 else "")
        grads = ",\n                ".join(g.strip() for g in vjp)
        lines.append(f'''

class _{name}_fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, {", ".join(args)}):
        out = _{name}_pure({", ".join(args)})
        ctx.save_for_backward({res})
        return out

    @staticmethod
    def backward(ctx, g):
        ({res}) = ctx.saved_tensors
        return ({grads},)


def _{name}_cv({sig}):
    return _{name}_fn.apply({", ".join(args)})
''')
        core = f"_{name}_cv"

    factory = ", factory=True" if not args else ""
    lines.append(f'{name} = eager_op(name="{name}"{factory})({core})')
    doc = entry.get("doc", "").strip()
    if doc:
        lines.append(f'{name}.__doc__ = {doc!r}')
    return "\n".join(lines)


def gen_module(entries):
    chunks = [HEADER]
    for e in entries:
        chunks.append(gen_op(e))
        chunks.append("")
    chunks.append("# -- schema registry (the sharding hints, signatures and "
                  "custom-VJP marks) --")
    chunks.append("OP_INFO = {")
    for e in entries:
        attrs = {a["name"]: ("<required>" if a.get("required")
                             else a["default"])
                 for a in (e.get("attrs") or [])}
        chunks.append(
            f'    "{e["op"]}": {{"args": {e["args"]!r}, '
            f'"attrs": {attrs!r}, '
            f'"sharding": {e.get("sharding", "elementwise")!r}, '
            f'"custom_vjp": {bool(e.get("vjp"))!r}}},')
    chunks.append("}")
    chunks.append("")
    # OP_TESTS: each entry's test spec and args, so a run without the
    # yaml (chip_smoke.py's op_surface on the card) builds the same cases
    chunks.append("# -- the schema's test specs (kind, input ranges or the "
                  "input DSL, attrs, tolerances) --")
    chunks.append("OP_TESTS = {")
    for e in entries:
        spec = {"args": list(e["args"]), **(e.get("test") or {})}
        chunks.append(f'    "{e["op"]}": {spec!r},')
    chunks.append("}")
    chunks.append("")
    names = [e["op"] for e in entries]
    chunks.append(f"__all__ = {names!r} + ['OP_INFO', 'OP_TESTS']")
    chunks.append("")
    return "\n".join(chunks)


def load_entries():
    with open(YAML_PATH) as f:
        entries = yaml.safe_load(f)
    seen = set()
    for e in entries:
        if e["op"] in seen:
            raise ValueError(f"duplicate op {e['op']}")
        seen.add(e["op"])
    return entries


def main():
    entries = load_entries()
    src = gen_module(entries)
    with open(OUT_PATH, "w") as f:
        f.write(src)
    print(f"wrote {os.path.normpath(OUT_PATH)} ({len(entries)} ops)")


if __name__ == "__main__":
    main()
