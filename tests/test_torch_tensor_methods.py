"""``core/tensor_methods.py``: the op surface's names that
``torch.Tensor`` lacks are installed on it and call the port's ops
(against the JAX package's methods on the same inputs, 1e-6), and no
attribute torch already had was replaced."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu_torch  # noqa: F401  (installs the methods)
from paddle_tpu_torch.core import tensor_methods as TM
from paddle_tpu_torch.ops import manipulation, math

TOL = 1e-6


def _x(seed=0, shape=(3, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_installed_names_are_the_table_minus_torch():
    """Every installed name is in the JAX table's modules (or its
    extras), absent from a bare torch.Tensor, and bound to the port's
    function of that name."""
    import paddle_tpu.core.tensor_methods as JTM
    assert TM.INSTALLED, "nothing installed"
    jax_names = set(JTM._EXTRA_METHODS) | {"rank"}
    for mod in JTM._METHOD_SOURCES:
        jax_names |= set(getattr(mod, "__all__", []))
    for name, fn in TM.INSTALLED.items():
        assert name in jax_names, name
        assert getattr(torch.Tensor, name) is fn
        assert name not in vars(torch._C.TensorBase), name
    assert "rank" in TM.INSTALLED and "concat" in TM.INSTALLED


# The names installed under the torch these tests run on (2.13).  A
# torch release that gives torch.Tensor one of them takes the name over
# (the port's method is then not installed, and `x.name(...)` means
# torch's); one that drops a torch method lets the port's in.  Either
# shows here first: read the change and write the list again.
PINNED = frozenset({
    "arange", "as_complex", "as_real", "atleast_1d", "atleast_2d",
    "atleast_3d", "block_diag", "broadcast_tensors", "bucketize",
    "cartesian_prod", "cast", "cdist", "celu", "column_stack",
    "combinations", "complex", "concat", "cond", "crop",
    "cumulative_trapezoid", "dstack", "eigh", "eigvals", "eigvalsh",
    "einsum", "elu", "empty", "empty_like", "equal_all", "eye", "fft",
    "fft2", "fftfreq", "fftn", "fftshift", "fill_diagonal", "floor_mod",
    "full", "full_like", "gather_nd", "gelu", "glu", "greater_than",
    "hardsigmoid", "hardswish", "hardtanh", "hfft",
    "histogram_bin_edges", "histogramdd", "householder_product",
    "hstack", "i0e", "i1", "i1e", "ifft", "ifft2", "ifftn", "ifftshift",
    "ihfft", "increment", "index_sample", "irfft", "irfft2", "irfftn",
    "is_integer", "isin", "leaky_relu", "less_than", "linspace",
    "log_sigmoid", "logspace", "masked_argmax", "matrix_norm",
    "matrix_rank", "matrix_transpose", "mish", "mod", "multi_dot",
    "multiplex", "ones", "ones_like", "pad", "pdist", "pinv", "polar",
    "put_along_axis", "rank", "relu6", "rfft", "rfft2", "rfftfreq",
    "rfftn", "rot90_", "row_stack", "scale", "scatter_nd",
    "scatter_nd_add", "searchsorted", "selu", "shard_index", "silu",
    "slice", "softplus", "softshrink", "softsign", "stack", "stanh",
    "strided_slice", "svdvals", "swish", "take_along_axis",
    "tanhshrink", "tensordot", "thresholded_relu", "trapezoid",
    "tril_indices", "triu_indices", "unstack", "vander", "vecdot",
    "vector_norm", "vstack", "zeros", "zeros_like"})


def test_installed_set_is_pinned():
    got = set(TM.INSTALLED)
    assert got == PINNED, (f"torch took over {sorted(PINNED - got)}; "
                           f"newly installed {sorted(got - PINNED)}")


def test_torch_attributes_untouched():
    """Names torch has keep torch's objects: methods, properties and
    the operators (which the JAX package replaces on its own Tensor)."""
    for name in ("add", "matmul", "T", "mT", "dim", "where", "tril",
                 "element_size", "__add__", "__eq__", "__matmul__",
                 "__getitem__", "numpy", "sum", "reshape"):
        assert name not in TM.INSTALLED
        base = getattr(torch._C.TensorBase, name, None)
        own = vars(torch.Tensor).get(name)
        assert own is not None or base is not None
    x = torch.ones(2, 3)
    assert (x + x).sum().item() == 12.0
    assert x.T.shape == (3, 2)


@pytest.mark.parametrize("name,args,kw", [
    ("concat", None, {"axis": 1}),
    ("stack", None, {"axis": 0}),
    ("cast", ("int32",), {}),
    ("floor_mod", (1.5,), {}),
    ("greater_than", (0.0,), {}),
    ("less_than", (0.5,), {}),
    ("tensordot", (None,), {"axes": 2}),
    ("scale", (), {"scale": 2.0, "bias": 1.0}),
    ("unstack", (), {"axis": 1}),
    ("vector_norm", (), {}),
    ("zeros_like", (), {}),
    ("full_like", (3.0,), {}),
])
def test_installed_method_matches_jax(name, args, kw):
    assert name in TM.INSTALLED
    x = _x()
    tx, jx = torch.from_numpy(x), pp.to_tensor(x)
    if args is None:           # list ops: the tensor with itself
        got = getattr(manipulation, name)([tx, tx], **kw)
        want = getattr(pp, name)([jx, jx], **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL)
        return
    if args[:1] == (None,):    # the second operand: the tensor itself
        args = (tx,) + args[1:]
        jargs = (jx,) + tuple(args[1:])
    else:
        jargs = args
    got = getattr(tx, name)(*args, **kw)
    want = getattr(jx, name)(*jargs, **kw)
    if isinstance(got, (list, tuple)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL)
        return
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                               np.asarray(want.numpy(), np.float64),
                               rtol=TOL, atol=TOL)


def test_rank_and_method_routes_through_the_op():
    x = torch.ones(2, 3, 4)
    assert x.rank() == 3
    assert x.cast("int32").dtype == torch.int32
    assert TM.INSTALLED["floor_mod"] is math.floor_mod
    assert torch.equal(x.floor_mod(0.75), math.floor_mod(x, 0.75))
