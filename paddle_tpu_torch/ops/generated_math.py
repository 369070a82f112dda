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


def _add_pure(x, y):
    return torch.add(x, y)
add = eager_op(name="add")(_add_pure)
add.__doc__ = 'Elementwise x + y with broadcasting.'

def _subtract_pure(x, y):
    return torch.subtract(x, y)
subtract = eager_op(name="subtract")(_subtract_pure)
subtract.__doc__ = 'Elementwise x - y with broadcasting.'

def _multiply_pure(x, y):
    return torch.multiply(x, y)
multiply = eager_op(name="multiply")(_multiply_pure)
multiply.__doc__ = 'Elementwise x * y with broadcasting.'

def _divide_pure(x, y):
    return torch.true_divide(x, y)
divide = eager_op(name="divide")(_divide_pure)
divide.__doc__ = 'Elementwise x / y (true division).'

def _floor_divide_pure(x, y):
    return torch.floor_divide(x, y)
floor_divide = eager_op(name="floor_divide")(_floor_divide_pure)
floor_divide.__doc__ = 'Elementwise floor(x / y).'

def _remainder_pure(x, y):
    return torch.remainder(x, y)
remainder = eager_op(name="remainder")(_remainder_pure)
remainder.__doc__ = 'Elementwise python-style modulus.'

def _pow_pure(x, y):
    return torch.pow(x, y)
pow = eager_op(name="pow")(_pow_pure)
pow.__doc__ = 'Elementwise x ** y.'

def _maximum_pure(x, y):
    return torch.maximum(x, y)
maximum = eager_op(name="maximum")(_maximum_pure)
maximum.__doc__ = 'Elementwise max(x, y).'

def _minimum_pure(x, y):
    return torch.minimum(x, y)
minimum = eager_op(name="minimum")(_minimum_pure)
minimum.__doc__ = 'Elementwise min(x, y).'

def _fmax_pure(x, y):
    return torch.fmax(x, y)
fmax = eager_op(name="fmax")(_fmax_pure)
fmax.__doc__ = 'Elementwise max ignoring NaN.'

def _fmin_pure(x, y):
    return torch.fmin(x, y)
fmin = eager_op(name="fmin")(_fmin_pure)
fmin.__doc__ = 'Elementwise min ignoring NaN.'

def _atan2_pure(x, y):
    return torch.atan2(x, y)
atan2 = eager_op(name="atan2")(_atan2_pure)
atan2.__doc__ = 'Elementwise arctan(x / y) using signs to pick the quadrant.'

def _heaviside_pure(x, y):
    return torch.heaviside(x, y)
heaviside = eager_op(name="heaviside")(_heaviside_pure)
heaviside.__doc__ = 'Heaviside step function with y at x == 0.'

def _gcd_pure(x, y):
    return torch.gcd(x, y)
gcd = eager_op(name="gcd")(_gcd_pure)
gcd.__doc__ = 'Elementwise greatest common divisor (integer inputs).'

def _lcm_pure(x, y):
    return torch.lcm(x, y)
lcm = eager_op(name="lcm")(_lcm_pure)
lcm.__doc__ = 'Elementwise least common multiple (integer inputs).'

def _hypot_pure(x, y):
    return torch.hypot(x, y)
hypot = eager_op(name="hypot")(_hypot_pure)
hypot.__doc__ = 'Elementwise sqrt(x^2 + y^2).'

def _logaddexp_pure(x, y):
    return torch.logaddexp(x, y)
logaddexp = eager_op(name="logaddexp")(_logaddexp_pure)
logaddexp.__doc__ = 'log(exp(x) + exp(y)) computed stably.'

def _logaddexp2_pure(x, y):
    return torch.logaddexp2(x, y)
logaddexp2 = eager_op(name="logaddexp2")(_logaddexp2_pure)
logaddexp2.__doc__ = 'log2(2^x + 2^y) computed stably.'

def _copysign_pure(x, y):
    return torch.copysign(x, y)
copysign = eager_op(name="copysign")(_copysign_pure)
copysign.__doc__ = 'Magnitude of x with the sign of y.'

def _nextafter_pure(x, y):
    return torch.nextafter(x, y)
nextafter = eager_op(name="nextafter")(_nextafter_pure)
nextafter.__doc__ = 'Next representable float after x toward y.'

def _ldexp_pure(x, y):
    return torch.ldexp(x, y)
ldexp = eager_op(name="ldexp")(_ldexp_pure)
ldexp.__doc__ = 'x * 2**y.'

def _inner_pure(x, y):
    return torch.inner(x, y)
inner = eager_op(name="inner")(_inner_pure)
inner.__doc__ = 'Inner product over the last axes.'

def _outer_pure(x, y):
    return torch.outer(x, y)
outer = eager_op(name="outer")(_outer_pure)
outer.__doc__ = 'Outer product of flattened inputs.'

def _kron_pure(x, y):
    return torch.kron(x, y)
kron = eager_op(name="kron")(_kron_pure)
kron.__doc__ = 'Kronecker product.'

def _lerp_pure(x, y, weight):
    return x + weight * (y - x)
lerp = eager_op(name="lerp")(_lerp_pure)
lerp.__doc__ = 'Linear interpolation x + weight * (y - x).'

def _exp_pure(x):
    return torch.exp(x)
exp = eager_op(name="exp")(_exp_pure)
exp.__doc__ = 'Elementwise e**x.'

def _expm1_pure(x):
    return torch.expm1(x)
expm1 = eager_op(name="expm1")(_expm1_pure)
expm1.__doc__ = 'exp(x) - 1, accurate near 0.'

def _exp2_pure(x):
    return torch.exp2(x)
exp2 = eager_op(name="exp2")(_exp2_pure)
exp2.__doc__ = 'Elementwise 2**x.'

def _log_pure(x):
    return torch.log(x)
log = eager_op(name="log")(_log_pure)
log.__doc__ = 'Natural logarithm.'

def _log2_pure(x):
    return torch.log2(x)
log2 = eager_op(name="log2")(_log2_pure)
log2.__doc__ = 'Base-2 logarithm.'

def _log10_pure(x):
    return torch.log10(x)
log10 = eager_op(name="log10")(_log10_pure)
log10.__doc__ = 'Base-10 logarithm.'

def _log1p_pure(x):
    return torch.log1p(x)
log1p = eager_op(name="log1p")(_log1p_pure)
log1p.__doc__ = 'log(1 + x), accurate near 0.'

def _sqrt_pure(x):
    return torch.sqrt(x)
sqrt = eager_op(name="sqrt")(_sqrt_pure)
sqrt.__doc__ = 'Elementwise square root.'

def _rsqrt_pure(x):
    return torch.rsqrt(x)


class _rsqrt_fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _rsqrt_pure(x)
        ctx.save_for_backward(out,)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return (-0.5 * g * out * out * out,)


def _rsqrt_cv(x):
    return _rsqrt_fn.apply(x)

rsqrt = eager_op(name="rsqrt")(_rsqrt_cv)
rsqrt.__doc__ = 'Elementwise 1 / sqrt(x); custom vjp -0.5 * g * out^3.'

def _reciprocal_pure(x):
    return 1.0 / x


class _reciprocal_fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _reciprocal_pure(x)
        ctx.save_for_backward(out,)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return (-g * out * out,)


def _reciprocal_cv(x):
    return _reciprocal_fn.apply(x)

reciprocal = eager_op(name="reciprocal")(_reciprocal_cv)
reciprocal.__doc__ = 'Elementwise 1 / x; custom vjp -g * out^2.'

def _abs_pure(x):
    return torch.abs(x)
abs = eager_op(name="abs")(_abs_pure)
abs.__doc__ = 'Elementwise absolute value.'

def _square_pure(x):
    return torch.square(x)


class _square_fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _square_pure(x)
        ctx.save_for_backward(x,)
        return out

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (2.0 * g * x,)


def _square_cv(x):
    return _square_fn.apply(x)

square = eager_op(name="square")(_square_cv)
square.__doc__ = 'Elementwise x**2; custom vjp 2 * g * x.'

def _ceil_pure(x):
    return torch.ceil(x)
ceil = eager_op(name="ceil")(_ceil_pure)
ceil.__doc__ = 'Elementwise ceiling.'

def _floor_pure(x):
    return torch.floor(x)
floor = eager_op(name="floor")(_floor_pure)
floor.__doc__ = 'Elementwise floor.'

def _round_pure(x):
    return torch.round(x)
round = eager_op(name="round")(_round_pure)
round.__doc__ = 'Round to nearest even.'

def _trunc_pure(x):
    return torch.trunc(x)
trunc = eager_op(name="trunc")(_trunc_pure)
trunc.__doc__ = 'Truncate toward zero.'

def _frac_pure(x):
    return x - torch.trunc(x)
frac = eager_op(name="frac")(_frac_pure)
frac.__doc__ = 'Fractional part x - trunc(x).'

def _sign_pure(x):
    return torch.sign(x)
sign = eager_op(name="sign")(_sign_pure)
sign.__doc__ = 'Elementwise sign.'

def _sin_pure(x):
    return torch.sin(x)
sin = eager_op(name="sin")(_sin_pure)
sin.__doc__ = 'Elementwise sine.'

def _cos_pure(x):
    return torch.cos(x)
cos = eager_op(name="cos")(_cos_pure)
cos.__doc__ = 'Elementwise cosine.'

def _tan_pure(x):
    return torch.tan(x)
tan = eager_op(name="tan")(_tan_pure)
tan.__doc__ = 'Elementwise tangent.'

def _asin_pure(x):
    return torch.asin(x)
asin = eager_op(name="asin")(_asin_pure)
asin.__doc__ = 'Elementwise inverse sine.'

def _acos_pure(x):
    return torch.acos(x)
acos = eager_op(name="acos")(_acos_pure)
acos.__doc__ = 'Elementwise inverse cosine.'

def _atan_pure(x):
    return torch.atan(x)
atan = eager_op(name="atan")(_atan_pure)
atan.__doc__ = 'Elementwise inverse tangent.'

def _sinh_pure(x):
    return torch.sinh(x)
sinh = eager_op(name="sinh")(_sinh_pure)
sinh.__doc__ = 'Hyperbolic sine.'

def _cosh_pure(x):
    return torch.cosh(x)
cosh = eager_op(name="cosh")(_cosh_pure)
cosh.__doc__ = 'Hyperbolic cosine.'

def _tanh_pure(x):
    return torch.tanh(x)
tanh = eager_op(name="tanh")(_tanh_pure)
tanh.__doc__ = 'Hyperbolic tangent.'

def _asinh_pure(x):
    return torch.asinh(x)
asinh = eager_op(name="asinh")(_asinh_pure)
asinh.__doc__ = 'Inverse hyperbolic sine.'

def _acosh_pure(x):
    return torch.acosh(x)
acosh = eager_op(name="acosh")(_acosh_pure)
acosh.__doc__ = 'Inverse hyperbolic cosine.'

def _atanh_pure(x):
    return torch.atanh(x)
atanh = eager_op(name="atanh")(_atanh_pure)
atanh.__doc__ = 'Inverse hyperbolic tangent.'

def _erf_pure(x):
    return torch.special.erf(x)
erf = eager_op(name="erf")(_erf_pure)
erf.__doc__ = 'Gauss error function.'

def _erfc_pure(x):
    return torch.special.erfc(x)
erfc = eager_op(name="erfc")(_erfc_pure)
erfc.__doc__ = 'Complementary error function 1 - erf(x).'

def _erfinv_pure(x):
    return torch.special.erfinv(x)
erfinv = eager_op(name="erfinv")(_erfinv_pure)
erfinv.__doc__ = 'Inverse error function.'

def _lgamma_pure(x):
    return torch.lgamma(x)
lgamma = eager_op(name="lgamma")(_lgamma_pure)
lgamma.__doc__ = 'Log absolute gamma.'

def _digamma_pure(x):
    return torch.digamma(x)
digamma = eager_op(name="digamma")(_digamma_pure)
digamma.__doc__ = 'Derivative of lgamma.'

def _polygamma_pure(x, n):
    return torch.polygamma(int(n), x)
polygamma = eager_op(name="polygamma")(_polygamma_pure)
polygamma.__doc__ = 'n-th derivative of digamma (n required, paddle parity).'

def _i0_pure(x):
    return torch.special.i0(x)
i0 = eager_op(name="i0")(_i0_pure)
i0.__doc__ = 'Modified Bessel function of order 0.'

def _i0e_pure(x):
    return torch.special.i0e(x)
i0e = eager_op(name="i0e")(_i0e_pure)
i0e.__doc__ = 'Exponentially scaled Bessel i0.'

def _i1_pure(x):
    return torch.special.i1(x)
i1 = eager_op(name="i1")(_i1_pure)
i1.__doc__ = 'Modified Bessel function of order 1.'

def _i1e_pure(x):
    return torch.special.i1e(x)
i1e = eager_op(name="i1e")(_i1e_pure)
i1e.__doc__ = 'Exponentially scaled Bessel i1.'

def _neg_pure(x):
    return torch.neg(x)
neg = eager_op(name="neg")(_neg_pure)
neg.__doc__ = 'Elementwise negation.'

def _deg2rad_pure(x):
    return torch.deg2rad(x)
deg2rad = eager_op(name="deg2rad")(_deg2rad_pure)
deg2rad.__doc__ = 'Degrees to radians.'

def _rad2deg_pure(x):
    return torch.rad2deg(x)
rad2deg = eager_op(name="rad2deg")(_rad2deg_pure)
rad2deg.__doc__ = 'Radians to degrees.'

def _angle_pure(x):
    return torch.angle(x)
angle = eager_op(name="angle")(_angle_pure)
angle.__doc__ = 'Phase angle of a complex (or real) input.'

def _conj_pure(x):
    return torch.conj_physical(x)
conj = eager_op(name="conj")(_conj_pure)
conj.__doc__ = 'Complex conjugate.'

def _real_pure(x):
    return torch.real(x) if x.is_complex() else x.clone()
real = eager_op(name="real")(_real_pure)
real.__doc__ = 'Real part.'

def _imag_pure(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)
imag = eager_op(name="imag")(_imag_pure)
imag.__doc__ = 'Imaginary part.'

def _isnan_pure(x):
    return torch.isnan(x)
isnan = eager_op(name="isnan")(_isnan_pure)
isnan.__doc__ = 'Elementwise NaN test.'

def _isinf_pure(x):
    return torch.isinf(x)
isinf = eager_op(name="isinf")(_isinf_pure)
isinf.__doc__ = 'Elementwise infinity test.'

def _isfinite_pure(x):
    return torch.isfinite(x)
isfinite = eager_op(name="isfinite")(_isfinite_pure)
isfinite.__doc__ = 'Elementwise finiteness test.'

def _sigmoid_pure(x):
    return torch.sigmoid(x)
sigmoid = eager_op(name="sigmoid")(_sigmoid_pure)
sigmoid.__doc__ = 'Logistic sigmoid 1 / (1 + exp(-x)).'

def _logit_pure(x, eps=None):
    return torch.logit(x if eps is None else torch.clamp(x, eps, 1 - eps))
logit = eager_op(name="logit")(_logit_pure)
logit.__doc__ = 'Inverse sigmoid log(x / (1-x)), optionally eps-clipped.'

def _stanh_pure(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)
stanh = eager_op(name="stanh")(_stanh_pure)
stanh.__doc__ = 'Scaled tanh scale_b * tanh(scale_a * x).'

def _nan_to_num_pure(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)
nan_to_num = eager_op(name="nan_to_num")(_nan_to_num_pure)
nan_to_num.__doc__ = 'Replace NaN/inf with finite numbers.'

def _clip_pure(x, min=None, max=None):
    return x if min is None and max is None else torch.clamp(x, min, max)
clip = eager_op(name="clip")(_clip_pure)
clip.__doc__ = 'Clamp to [min, max].'

def _scale_pure(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    return x * scale + bias if bias_after_scale else (x + bias) * scale
scale = eager_op(name="scale")(_scale_pure)
scale.__doc__ = 'x * scale + bias (or (x + bias) * scale); act accepted for signature parity (unused, as in the legacy wrapper).'

def _increment_pure(x, value=1.0):
    return x + value
increment = eager_op(name="increment")(_increment_pure)
increment.__doc__ = 'x + value.'

def _sum_pure(x, axis=None, dtype=None, keepdim=False):
    return torch.sum(x, dim=_axis(axis), dtype=_dt(dtype), keepdim=keepdim)
sum = eager_op(name="sum")(_sum_pure)
sum.__doc__ = 'Sum over axis (None = all).'

def _mean_pure(x, axis=None, keepdim=False):
    return torch.mean(_f(x), dim=_axis(axis), keepdim=keepdim)
mean = eager_op(name="mean")(_mean_pure)
mean.__doc__ = 'Mean over axis.'

def _max_pure(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)
max = eager_op(name="max")(_max_pure)
max.__doc__ = 'Max over axis.'

def _min_pure(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)
min = eager_op(name="min")(_min_pure)
min.__doc__ = 'Min over axis.'

def _amax_pure(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)
amax = eager_op(name="amax")(_amax_pure)
amax.__doc__ = 'Max over axis (alias family of max).'

def _amin_pure(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)
amin = eager_op(name="amin")(_amin_pure)
amin.__doc__ = 'Min over axis (alias family of min).'

def _prod_pure(x, axis=None, keepdim=False, dtype=None):
    out = x if dtype is None else x.to(_dt(dtype))
    for d in builtins.sorted(_dims(x, axis), reverse=True):
        out = torch.prod(out, d, keepdim=keepdim)
    return out
prod = eager_op(name="prod")(_prod_pure)
prod.__doc__ = 'Product over axis.'

def _logsumexp_pure(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)
logsumexp = eager_op(name="logsumexp")(_logsumexp_pure)
logsumexp.__doc__ = 'log(sum(exp(x))) computed stably.'

def _count_nonzero_pure(x, axis=None, keepdim=False):
    return torch.sum(x != 0, dim=_axis(axis), keepdim=keepdim)
count_nonzero = eager_op(name="count_nonzero")(_count_nonzero_pure)
count_nonzero.__doc__ = 'Count of nonzero elements over axis.'

def _nansum_pure(x, axis=None, dtype=None, keepdim=False):
    return torch.nansum(x, dim=_axis(axis), dtype=_dt(dtype), keepdim=keepdim)
nansum = eager_op(name="nansum")(_nansum_pure)
nansum.__doc__ = 'Sum ignoring NaN.'

def _nanmean_pure(x, axis=None, keepdim=False):
    return torch.nanmean(x, dim=_axis(axis), keepdim=keepdim)
nanmean = eager_op(name="nanmean")(_nanmean_pure)
nanmean.__doc__ = 'Mean ignoring NaN.'

def _all_pure(x, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=_dims(x, axis), keepdim=keepdim)
all = eager_op(name="all")(_all_pure)
all.__doc__ = 'Logical AND over axis.'

def _any_pure(x, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=_dims(x, axis), keepdim=keepdim)
any = eager_op(name="any")(_any_pure)
any.__doc__ = 'Logical OR over axis.'

def _cumsum_pure(x, axis=None, dtype=None):
    if axis is None:
        x = torch.reshape(x, (-1,))
        axis = 0
    return torch.cumsum(x, dim=int(axis), dtype=_dt(dtype))
cumsum = eager_op(name="cumsum")(_cumsum_pure)
cumsum.__doc__ = 'Cumulative sum (axis None flattens first).'

def _cumprod_pure(x, dim=None, dtype=None):
    if dim is None:
        x = torch.reshape(x, (-1,))
        dim = 0
    return torch.cumprod(x, dim=int(dim), dtype=_dt(dtype))
cumprod = eager_op(name="cumprod")(_cumprod_pure)
cumprod.__doc__ = 'Cumulative product (dim None flattens first).'

def _logcumsumexp_pure(x, axis=None):
    if axis is None:
        x = torch.reshape(x, (-1,))
        axis = 0
    return torch.logcumsumexp(x, dim=int(axis))
logcumsumexp = eager_op(name="logcumsumexp")(_logcumsumexp_pure)
logcumsumexp.__doc__ = 'Stable log of cumulative sum of exponentials.'

def _trace_pure(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)
trace = eager_op(name="trace")(_trace_pure)
trace.__doc__ = 'Sum of a diagonal.'

def _diagonal_pure(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)
diagonal = eager_op(name="diagonal")(_diagonal_pure)
diagonal.__doc__ = 'Extract a diagonal.'

def _addmm_pure(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * torch.matmul(x, y)
addmm = eager_op(name="addmm")(_addmm_pure)
addmm.__doc__ = 'beta * input + alpha * (x @ y).'

def _diff_pure(x, n=1, axis=-1, prepend=None, append=None):
    return torch.diff(x, n=n, dim=axis, prepend=prepend, append=append)
diff = eager_op(name="diff")(_diff_pure)
diff.__doc__ = 'n-th discrete difference along axis.'

def _equal_pure(x, y):
    return torch.eq(x, y)
equal = eager_op(name="equal")(_equal_pure)
equal.__doc__ = 'Elementwise x == y.'

def _not_equal_pure(x, y):
    return torch.ne(x, y)
not_equal = eager_op(name="not_equal")(_not_equal_pure)
not_equal.__doc__ = 'Elementwise x != y.'

def _greater_than_pure(x, y):
    return torch.gt(x, y)
greater_than = eager_op(name="greater_than")(_greater_than_pure)
greater_than.__doc__ = 'Elementwise x > y.'

def _greater_equal_pure(x, y):
    return torch.ge(x, y)
greater_equal = eager_op(name="greater_equal")(_greater_equal_pure)
greater_equal.__doc__ = 'Elementwise x >= y.'

def _less_than_pure(x, y):
    return torch.lt(x, y)
less_than = eager_op(name="less_than")(_less_than_pure)
less_than.__doc__ = 'Elementwise x < y.'

def _less_equal_pure(x, y):
    return torch.le(x, y)
less_equal = eager_op(name="less_equal")(_less_equal_pure)
less_equal.__doc__ = 'Elementwise x <= y.'

def _logical_and_pure(x, y):
    return torch.logical_and(x, y)
logical_and = eager_op(name="logical_and")(_logical_and_pure)
logical_and.__doc__ = 'Elementwise boolean and.'

def _logical_or_pure(x, y):
    return torch.logical_or(x, y)
logical_or = eager_op(name="logical_or")(_logical_or_pure)
logical_or.__doc__ = 'Elementwise boolean or.'

def _logical_xor_pure(x, y):
    return torch.logical_xor(x, y)
logical_xor = eager_op(name="logical_xor")(_logical_xor_pure)
logical_xor.__doc__ = 'Elementwise boolean xor.'

def _logical_not_pure(x):
    return torch.logical_not(x)
logical_not = eager_op(name="logical_not")(_logical_not_pure)
logical_not.__doc__ = 'Elementwise boolean not.'

def _isclose_pure(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)
isclose = eager_op(name="isclose")(_isclose_pure)
isclose.__doc__ = 'Elementwise approximate equality.'

def _allclose_pure(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan).all()
allclose = eager_op(name="allclose")(_allclose_pure)
allclose.__doc__ = 'Scalar approximate array equality.'

def _equal_all_pure(x, y):
    if builtins.tuple(x.shape) != builtins.tuple(y.shape):
        return torch.tensor(False, device=x.device)
    return torch.eq(x, y).all()
equal_all = eager_op(name="equal_all")(_equal_all_pure)
equal_all.__doc__ = 'Scalar exact array equality.'

def _bitwise_and_pure(x, y):
    return torch.bitwise_and(x, y)
bitwise_and = eager_op(name="bitwise_and")(_bitwise_and_pure)
bitwise_and.__doc__ = 'Elementwise bitwise and (bool/int).'

def _bitwise_or_pure(x, y):
    return torch.bitwise_or(x, y)
bitwise_or = eager_op(name="bitwise_or")(_bitwise_or_pure)
bitwise_or.__doc__ = 'Elementwise bitwise or (bool/int).'

def _bitwise_xor_pure(x, y):
    return torch.bitwise_xor(x, y)
bitwise_xor = eager_op(name="bitwise_xor")(_bitwise_xor_pure)
bitwise_xor.__doc__ = 'Elementwise bitwise xor (bool/int).'

def _bitwise_not_pure(x):
    return torch.bitwise_not(x)
bitwise_not = eager_op(name="bitwise_not")(_bitwise_not_pure)
bitwise_not.__doc__ = 'Elementwise bitwise not (bool/int).'

def _bitwise_left_shift_pure(x, y):
    return torch.bitwise_left_shift(x, y)
bitwise_left_shift = eager_op(name="bitwise_left_shift")(_bitwise_left_shift_pure)
bitwise_left_shift.__doc__ = 'Elementwise left shift.'

def _bitwise_right_shift_pure(x, y):
    return torch.bitwise_right_shift(x, y)
bitwise_right_shift = eager_op(name="bitwise_right_shift")(_bitwise_right_shift_pure)
bitwise_right_shift.__doc__ = 'Elementwise right shift.'

def _signbit_pure(x):
    return torch.signbit(x)
signbit = eager_op(name="signbit")(_signbit_pure)
signbit.__doc__ = 'True where the sign bit is set.'

def _sinc_pure(x):
    return torch.sinc(x)
sinc = eager_op(name="sinc")(_sinc_pure)
sinc.__doc__ = 'Normalized sinc sin(pi x)/(pi x).'

def _take_pure(x, index, mode='raise'):
    flat = torch.reshape(x, (-1,))
    n = flat.numel()
    index = torch.as_tensor(index, device=x.device)
    if mode == 'raise':
        if index.numel() and (int(index.max()) >= n
                              or int(index.min()) < -n):
            raise IndexError(
                f"take: index out of range for {n} elements")
        return flat[torch.where(index < 0, index + n, index)]
    if mode == 'wrap':
        return flat[torch.remainder(index, n)]
    return flat[torch.clamp(index, 0, n - 1)]
take = eager_op(name="take")(_take_pure)
take.__doc__ = "Flattened-index gather; mode='raise' checks bounds eagerly (clamps under jit, where raising is impossible), clip/wrap as numpy."

def _isin_pure(x, test_x, assume_unique=False, invert=False):
    return torch.isin(x, test_x, assume_unique=assume_unique, invert=invert)
isin = eager_op(name="isin")(_isin_pure)
isin.__doc__ = 'Elementwise membership test.'

def _vander_pure(x, n=None, increasing=False):
    return torch.vander(x, N=n, increasing=increasing)
vander = eager_op(name="vander")(_vander_pure)
vander.__doc__ = 'Vandermonde matrix of a 1-D input.'

def _trapezoid_pure(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)
trapezoid = eager_op(name="trapezoid")(_trapezoid_pure)
trapezoid.__doc__ = 'Trapezoidal-rule integral along axis.'

def _cdist_pure(x, y, p=2.0, compute_mode='use_mm_for_euclid_dist_if_necessary'):
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == 0:
        return (diff != 0).sum(-1).to(x.dtype)
    if math.isinf(p):
        return diff.amax(-1)
    return (diff ** p).sum(-1) ** (1.0 / p)
cdist = eager_op(name="cdist")(_cdist_pure)
cdist.__doc__ = 'Pairwise p-norm distance matrix between row vectors.'

def _diag_embed_pure(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset=int(offset), dim1=int(dim1),
                            dim2=int(dim2))
diag_embed = eager_op(name="diag_embed")(_diag_embed_pure)
diag_embed.__doc__ = 'Embed the last axis as a (offset) diagonal of a new matrix pair.'

def _fill_diagonal_pure(x, value=0.0, offset=0, wrap=False):
    rows, cols = x.shape[-2], x.shape[-1]
    out = x.clone()
    if wrap and offset == 0 and x.ndim == 2 and rows > cols:
        # paddle fill_diagonal_(wrap=True): restart the diagonal every
        # (cols+1) rows on tall matrices
        r = torch.arange(rows, device=x.device)
        rr = r[(r % (cols + 1)) < cols]
        out[rr, rr % (cols + 1)] = value
        return out
    n = builtins.min(rows - builtins.max(-offset, 0),
                     cols - builtins.max(offset, 0))
    idx = torch.arange(builtins.max(n, 0), device=x.device)
    out[..., idx + builtins.max(-offset, 0),
        idx + builtins.max(offset, 0)] = value
    return out
fill_diagonal = eager_op(name="fill_diagonal")(_fill_diagonal_pure)
fill_diagonal.__doc__ = 'Return a copy with the (offset) diagonal set to value.'

def _reshape_pure(x, shape):
    return torch.reshape(x, builtins.tuple(int(s) for s in shape))
reshape = eager_op(name="reshape")(_reshape_pure)
reshape.__doc__ = 'Reshape to `shape` (one dim may be -1).'

def _cast_pure(x, dtype):
    return x.to(_dt(dtype))
cast = eager_op(name="cast")(_cast_pure)
cast.__doc__ = 'Cast to `dtype` (paddle dtype name or jax dtype).'

def _flatten_pure(x, start_axis=0, stop_axis=-1):
    nd = x.ndim
    a = start_axis % nd if nd else 0
    b = stop_axis % nd if nd else 0
    lead = builtins.tuple(x.shape[:a])
    tail = builtins.tuple(x.shape[b + 1:])
    return torch.reshape(x, lead + (-1,) + tail)
flatten = eager_op(name="flatten")(_flatten_pure)
flatten.__doc__ = 'Flatten dims start_axis..stop_axis into one.'

def _transpose_pure(x, perm):
    return torch.permute(x, builtins.tuple(int(p) for p in perm))
transpose = eager_op(name="transpose")(_transpose_pure)
transpose.__doc__ = 'Permute dimensions by `perm`.'

def _moveaxis_pure(x, source, destination):
    return torch.movedim(x, source, destination)
moveaxis = eager_op(name="moveaxis")(_moveaxis_pure)
moveaxis.__doc__ = 'Move axes from `source` to `destination`.'

def _swapaxes_pure(x, axis0, axis1):
    return torch.swapaxes(x, int(axis0), int(axis1))
swapaxes = eager_op(name="swapaxes")(_swapaxes_pure)
swapaxes.__doc__ = 'Swap two axes (paddle transpose alias pair).'

def _t_pure(x):
    if x.ndim < 2:
        return x
    return torch.swapaxes(x, -2, -1)
t = eager_op(name="t")(_t_pure)
t.__doc__ = 'Transpose a 0/1/2-D tensor (matrix transpose).'

def _matrix_transpose_pure(x):
    return torch.swapaxes(x, -2, -1)
matrix_transpose = eager_op(name="matrix_transpose")(_matrix_transpose_pure)
matrix_transpose.__doc__ = 'Transpose the last two dims (paddle.linalg.matrix_transpose).'

def _squeeze_pure(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = _axis(axis)
    ax = ax if builtins.isinstance(ax, builtins.tuple) else (ax,)
    ax = builtins.tuple(a for a in ax if x.shape[a] == 1)
    return torch.squeeze(x, ax) if ax else x
squeeze = eager_op(name="squeeze")(_squeeze_pure)
squeeze.__doc__ = 'Drop size-1 dims (all, or those named by axis that are 1).'

def _unsqueeze_pure(x, axis):
    ax = _axis(axis)
    ax = ax if builtins.isinstance(ax, builtins.tuple) else (ax,)
    nd = x.ndim + builtins.len(ax)
    for a in builtins.sorted(a % nd for a in ax):
        x = torch.unsqueeze(x, a)
    return x
unsqueeze = eager_op(name="unsqueeze")(_unsqueeze_pure)
unsqueeze.__doc__ = 'Insert size-1 dims at `axis`.'

def _concat_pure(x, axis=0):
    return torch.cat(builtins.list(x), dim=int(axis))
concat = eager_op(name="concat")(_concat_pure)
concat.__doc__ = 'Concatenate a list of tensors along `axis`.'

def _stack_pure(x, axis=0):
    return torch.stack(builtins.list(x), dim=int(axis))
stack = eager_op(name="stack")(_stack_pure)
stack.__doc__ = 'Stack a list of tensors along a new `axis`.'

def _unstack_pure(x, axis=0, num=None):
    n = x.shape[int(axis)] if num is None else int(num)
    return [torch.squeeze(s, int(axis))
            for s in torch.tensor_split(x, n, dim=int(axis))]
unstack = eager_op(name="unstack")(_unstack_pure)
unstack.__doc__ = "Split along `axis` into that dim's size single slices."

def _split_pure(x, num_or_sections, axis=0):
    ax = int(axis)
    if builtins.isinstance(num_or_sections, int):
        return builtins.list(_split(x, num_or_sections, ax))
    sizes = builtins.list(num_or_sections)
    total = x.shape[ax]
    if builtins.any(s in (-1, None) for s in sizes):
        known = builtins.sum(s for s in sizes if s not in (-1, None))
        sizes = [total - known if s in (-1, None) else s for s in sizes]
    idx = []
    acc = 0
    for s in sizes[:-1]:
        acc += int(s)
        idx.append(acc)
    return builtins.list(torch.tensor_split(x, idx, dim=ax))
split = eager_op(name="split")(_split_pure)
split.__doc__ = 'Split into `num_or_sections` (count or explicit sizes, -1 infers).'

def _chunk_pure(x, chunks, axis=0):
    return builtins.list(_split(x, int(chunks), int(axis)))
chunk = eager_op(name="chunk")(_chunk_pure)
chunk.__doc__ = 'Split into `chunks` equal parts along `axis`.'

def _tensor_split_pure(x, num_or_indices, axis=0):
    return builtins.list(torch.tensor_split(x, num_or_indices, dim=int(axis)))
tensor_split = eager_op(name="tensor_split")(_tensor_split_pure)
tensor_split.__doc__ = 'Split allowing non-divisible sizes (numpy array_split rule).'

def _hsplit_pure(x, num_or_indices):
    return builtins.list(_split(x, num_or_indices, 1))
hsplit = eager_op(name="hsplit")(_hsplit_pure)
hsplit.__doc__ = 'Split along axis 1 (columns).'

def _vsplit_pure(x, num_or_indices):
    return builtins.list(_split(x, num_or_indices, 0))
vsplit = eager_op(name="vsplit")(_vsplit_pure)
vsplit.__doc__ = 'Split along axis 0 (rows).'

def _dsplit_pure(x, num_or_indices):
    return builtins.list(_split(x, num_or_indices, 2))
dsplit = eager_op(name="dsplit")(_dsplit_pure)
dsplit.__doc__ = 'Split along axis 2 (depth).'

def _tile_pure(x, repeat_times):
    return torch.tile(x, builtins.tuple(int(r) for r in repeat_times))
tile = eager_op(name="tile")(_tile_pure)
tile.__doc__ = 'Repeat the tensor along each dim `repeat_times`.'

def _expand_pure(x, shape):
    tgt = builtins.list(shape)
    src = (1,) * (builtins.len(tgt) - x.ndim) + builtins.tuple(x.shape)
    out = [int(s) if int(t) == -1 else int(t)
           for t, s in builtins.zip(tgt, src)]
    return torch.broadcast_to(torch.reshape(x, src), builtins.tuple(out))
expand = eager_op(name="expand")(_expand_pure)
expand.__doc__ = 'Broadcast-expand to `shape` (-1 keeps the source dim).'

def _expand_as_pure(x, y):
    return torch.broadcast_to(x, y.shape)
expand_as = eager_op(name="expand_as")(_expand_as_pure)
expand_as.__doc__ = "Broadcast-expand x to y's shape."

def _broadcast_to_pure(x, shape):
    return torch.broadcast_to(x, builtins.tuple(int(s) for s in shape))
broadcast_to = eager_op(name="broadcast_to")(_broadcast_to_pure)
broadcast_to.__doc__ = 'Broadcast to `shape`.'

def _flip_pure(x, axis):
    return torch.flip(x, _dims(x, axis))
flip = eager_op(name="flip")(_flip_pure)
flip.__doc__ = 'Reverse along `axis`.'

def _rot90_pure(x, k=1, axes=(0, 1)):
    return torch.rot90(x, int(k), builtins.list(axes))
rot90 = eager_op(name="rot90")(_rot90_pure)
rot90.__doc__ = 'Rotate 90 degrees k times in the plane `axes`.'

def _roll_pure(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, _axis(axis))
roll = eager_op(name="roll")(_roll_pure)
roll.__doc__ = 'Circularly shift along `axis` (flattened when axis is None).'

def _gather_pure(x, index, axis=0):
    return _take(x, index, int(axis))
gather = eager_op(name="gather")(_gather_pure)
gather.__doc__ = 'Gather rows of `axis` by a 1-D index.'

def _gather_nd_pure(x, index):
    idx = builtins.tuple(torch.movedim(index, -1, 0))
    return x[idx]
gather_nd = eager_op(name="gather_nd")(_gather_nd_pure)
gather_nd.__doc__ = 'Gather slices by the trailing index coordinates.'

def _index_select_pure(x, index, axis=0):
    return _take(x, index, int(axis))
index_select = eager_op(name="index_select")(_index_select_pure)
index_select.__doc__ = 'Select entries of `axis` by index (paddle.index_select).'

def _index_sample_pure(x, index):
    return torch.take_along_dim(x, index, dim=1)
index_sample = eager_op(name="index_sample")(_index_sample_pure)
index_sample.__doc__ = 'Per-row gather by column index [N, M] -> [N, K].'

def _index_add_pure(x, index, value, axis):
    moved = torch.movedim(x, int(axis), 0)
    vmoved = torch.movedim(value, int(axis), 0)
    out = moved.index_add(0, index.reshape(-1), vmoved)
    return torch.movedim(out, 0, int(axis))
index_add = eager_op(name="index_add")(_index_add_pure)
index_add.__doc__ = 'Add `value` rows into x at `index` along `axis`.'

def _take_along_axis_pure(arr, indices, axis, broadcast=True):
    idx = indices
    if broadcast:
        tgt = builtins.list(arr.shape)
        tgt[int(axis)] = idx.shape[int(axis)]
        idx = torch.broadcast_to(idx, builtins.tuple(tgt))
    return torch.take_along_dim(arr, idx, dim=int(axis))
take_along_axis = eager_op(name="take_along_axis")(_take_along_axis_pure)
take_along_axis.__doc__ = 'Gather along `axis` with an index tensor (optionally broadcast).'

def _put_along_axis_pure(arr, indices, values, axis, reduce='assign'):
    ax = int(axis) % arr.ndim
    vals = torch.broadcast_to(torch.as_tensor(
        values, dtype=arr.dtype, device=arr.device), indices.shape)
    if reduce == "assign":
        return torch.scatter(arr, ax, indices, vals)
    if reduce in ("add", "sum"):
        return torch.scatter_add(arr, ax, indices, vals)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(arr, ax, indices, vals, "prod")
    raise ValueError(f"unknown reduce {reduce}")
put_along_axis = eager_op(name="put_along_axis")(_put_along_axis_pure)
put_along_axis.__doc__ = 'Scatter `values` along `axis` at `indices` (assign/add/mul).'

def _scatter_pure(x, index, updates, overwrite=True):
    if overwrite:
        return torch.index_put(x, (index,), updates)
    return torch.index_put(x, (index,), updates, accumulate=True)
scatter = eager_op(name="scatter")(_scatter_pure)
scatter.__doc__ = 'Row scatter by 1-D index (assign or accumulate).'

def _scatter_nd_pure(index, updates, shape):
    out = torch.zeros(builtins.tuple(int(s) for s in shape),
                      dtype=updates.dtype, device=updates.device)
    return torch.index_put(out, builtins.tuple(torch.movedim(index, -1, 0)),
                           updates, accumulate=True)
scatter_nd = eager_op(name="scatter_nd")(_scatter_nd_pure)
scatter_nd.__doc__ = 'Build a zeros tensor of `shape` and scatter-add `updates`.'

def _scatter_nd_add_pure(x, index, updates):
    return torch.index_put(x, builtins.tuple(torch.movedim(index, -1, 0)),
                           updates, accumulate=True)
scatter_nd_add = eager_op(name="scatter_nd_add")(_scatter_nd_add_pure)
scatter_nd_add.__doc__ = 'Scatter-add `updates` into x at nd coordinates.'

def _masked_fill_pure(x, mask, value):
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                           device=x.device), x)
masked_fill = eager_op(name="masked_fill")(_masked_fill_pure)
masked_fill.__doc__ = 'Fill positions where mask is True with `value`.'

def _where_pure(condition, x, y):
    return torch.where(condition, x, y)
where = eager_op(name="where")(_where_pure)
where.__doc__ = 'Elementwise select x where condition else y.'

def _repeat_interleave_pure(x, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(torch.reshape(x, (-1,)), int(repeats))
    return torch.repeat_interleave(x, int(repeats), dim=int(axis))
repeat_interleave = eager_op(name="repeat_interleave")(_repeat_interleave_pure)
repeat_interleave.__doc__ = 'Repeat each element `repeats` times (flattened when axis None).'

def _unbind_pure(x, axis=0):
    return builtins.list(torch.unbind(x, int(axis)))
unbind = eager_op(name="unbind")(_unbind_pure)
unbind.__doc__ = 'Split into single slices along `axis` (list of tensors).'

def _as_complex_pure(x):
    return torch.complex(x[..., 0], x[..., 1])
as_complex = eager_op(name="as_complex")(_as_complex_pure)
as_complex.__doc__ = 'View a trailing [..., 2] real tensor as complex.'

def _as_real_pure(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)
as_real = eager_op(name="as_real")(_as_real_pure)
as_real.__doc__ = 'View a complex tensor as trailing [..., 2] reals.'

def _crop_pure(x, shape=None, offsets=None):
    offs = offsets or [0] * x.ndim
    shp = [s if t in (-1, None) else t
           for t, s in builtins.zip(shape or x.shape, x.shape)]
    sl = builtins.tuple(builtins.slice(int(o), int(o) + int(s))
                        for o, s in builtins.zip(offs, shp))
    return x[sl]
crop = eager_op(name="crop")(_crop_pure)
crop.__doc__ = 'Crop a window of `shape` starting at `offsets`.'

def _atleast_1d_pure(x):
    return torch.atleast_1d(x)
atleast_1d = eager_op(name="atleast_1d")(_atleast_1d_pure)
atleast_1d.__doc__ = 'Promote to at least 1-D.'

def _atleast_2d_pure(x):
    return torch.atleast_2d(x)
atleast_2d = eager_op(name="atleast_2d")(_atleast_2d_pure)
atleast_2d.__doc__ = 'Promote to at least 2-D.'

def _atleast_3d_pure(x):
    return torch.atleast_3d(x)
atleast_3d = eager_op(name="atleast_3d")(_atleast_3d_pure)
atleast_3d.__doc__ = 'Promote to at least 3-D.'

def _hstack_pure(x):
    return torch.hstack(builtins.list(x))
hstack = eager_op(name="hstack")(_hstack_pure)
hstack.__doc__ = 'Stack a list horizontally (axis 1, or 0 for 1-D).'

def _vstack_pure(x):
    return torch.vstack(builtins.list(x))
vstack = eager_op(name="vstack")(_vstack_pure)
vstack.__doc__ = 'Stack a list vertically (axis 0).'

def _dstack_pure(x):
    return torch.dstack(builtins.list(x))
dstack = eager_op(name="dstack")(_dstack_pure)
dstack.__doc__ = 'Stack a list depthwise (axis 2).'

def _column_stack_pure(x):
    return torch.column_stack(builtins.list(x))
column_stack = eager_op(name="column_stack")(_column_stack_pure)
column_stack.__doc__ = 'Stack 1-D tensors as columns.'

def _row_stack_pure(x):
    return torch.vstack(builtins.list(x))
row_stack = eager_op(name="row_stack")(_row_stack_pure)
row_stack.__doc__ = 'Alias of vstack.'

def _numel_pure(x):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)
numel = eager_op(name="numel")(_numel_pure)
numel.__doc__ = 'Number of elements, as a 0-D int tensor.'

def _unflatten_pure(x, axis, shape):
    ax = int(axis) % x.ndim
    return torch.reshape(x, builtins.tuple(x.shape[:ax])
                         + builtins.tuple(int(s) for s in shape)
                         + builtins.tuple(x.shape[ax + 1:]))
unflatten = eager_op(name="unflatten")(_unflatten_pure)
unflatten.__doc__ = 'Split one dim into `shape`.'

def _diagonal_scatter_pure(x, y, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y, int(offset), int(axis1), int(axis2))
diagonal_scatter = eager_op(name="diagonal_scatter")(_diagonal_scatter_pure)
diagonal_scatter.__doc__ = 'Write `y` onto the (offset) diagonal of x.'

def _shard_index_pure(input, index_num, nshards, shard_id, ignore_value=-1):
    per = (int(index_num) + int(nshards) - 1) // int(nshards)
    lo = per * int(shard_id)
    hi = lo + per
    inside = (input >= lo) & (input < hi)
    return torch.where(inside, input - lo, ignore_value)
shard_index = eager_op(name="shard_index")(_shard_index_pure)
shard_index.__doc__ = 'Re-index a sharded id range (parameter-server embedding layout).'

def _argmax_pure(x, axis=None, keepdim=False, dtype='int64'):
    out = torch.argmax(x, dim=int(axis), keepdim=bool(keepdim)) \
        if axis is not None else torch.argmax(torch.reshape(x, (-1,)))
    return out.to(_dt(dtype))
argmax = eager_op(name="argmax")(_argmax_pure)
argmax.__doc__ = 'Index of the max along `axis` (flattened when None).'

def _argmin_pure(x, axis=None, keepdim=False, dtype='int64'):
    out = torch.argmin(x, dim=int(axis), keepdim=bool(keepdim)) \
        if axis is not None else torch.argmin(torch.reshape(x, (-1,)))
    return out.to(_dt(dtype))
argmin = eager_op(name="argmin")(_argmin_pure)
argmin.__doc__ = 'Index of the min along `axis` (flattened when None).'

def _argsort_pure(x, axis=-1, descending=False, stable=True):
    return _argsort(x, int(axis), bool(descending), bool(stable))
argsort = eager_op(name="argsort")(_argsort_pure)
argsort.__doc__ = 'Indices that sort along `axis`.'

def _sort_pure(x, axis=-1, descending=False, stable=True):
    out = torch.sort(x, dim=int(axis), stable=True).values
    return torch.flip(out, (int(axis),)) if descending else out
sort = eager_op(name="sort")(_sort_pure)
sort.__doc__ = 'Sorted values along `axis`.'

def _topk_pure(x, k, axis=None, largest=True, sorted=True):
    ax = -1 if axis is None else int(axis)
    moved = torch.movedim(x, ax, -1)
    vals, idx = _topk(moved, int(k), bool(largest))
    return (torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax))
topk = eager_op(name="topk")(_topk_pure)
topk.__doc__ = '(values, indices) of the k largest (or smallest) along `axis`.'

def _kthvalue_pure(x, k, axis=-1, keepdim=False):
    ax = int(axis)
    srt, idx = torch.sort(x, dim=ax, stable=True)
    vals = torch.select(srt, ax, int(k) - 1)
    inds = torch.select(idx, ax, int(k) - 1)
    if keepdim:
        vals = torch.unsqueeze(vals, ax)
        inds = torch.unsqueeze(inds, ax)
    return vals, inds
kthvalue = eager_op(name="kthvalue")(_kthvalue_pure)
kthvalue.__doc__ = '(value, index) of the k-th smallest along `axis` (1-based).'

def _searchsorted_pure(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, values,
                              out_int32=bool(out_int32), right=bool(right))
searchsorted = eager_op(name="searchsorted")(_searchsorted_pure)
searchsorted.__doc__ = 'Insertion indices into a sorted sequence (row-wise when 2-D).'

def _bucketize_pure(x, sorted_sequence, out_int32=False, right=False):
    return torch.bucketize(x, sorted_sequence, out_int32=bool(out_int32),
                           right=bool(right))
bucketize = eager_op(name="bucketize")(_bucketize_pure)
bucketize.__doc__ = 'Bucket index of each x in a 1-D sorted sequence.'

def _index_fill_pure(x, index, axis, value):
    return torch.index_fill(x, int(axis), index.reshape(-1), value)
index_fill = eager_op(name="index_fill")(_index_fill_pure)
index_fill.__doc__ = 'Fill slices at `index` along `axis` with `value`.'

def _var_pure(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(x, dim=_axis(axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))
var = eager_op(name="var")(_var_pure)
var.__doc__ = 'Variance along `axis` (unbiased by default, paddle parity).'

def _std_pure(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(x, dim=_axis(axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))
std = eager_op(name="std")(_std_pure)
std.__doc__ = 'Standard deviation along `axis` (unbiased by default).'

def _median_pure(x, axis=None, keepdim=False, mode='avg'):
    if mode == "avg":
        return _quantile(x, 0.5, axis, keepdim, "linear", torch.quantile)
    # mode == 'min': the lower middle element
    xs = torch.reshape(x, (-1,)) if axis is None else x
    use_ax = 0 if axis is None else int(axis)
    srt = torch.sort(xs, dim=use_ax).values
    out = torch.select(srt, use_ax, (srt.shape[use_ax] - 1) // 2)
    if keepdim and axis is not None:
        out = torch.unsqueeze(out, use_ax)
    return out
median = eager_op(name="median")(_median_pure)
median.__doc__ = "Median along `axis` ('avg' interpolates even counts, 'min' picks lower)."

def _nanmedian_pure(x, axis=None, keepdim=False):
    return _quantile(x, 0.5, axis, keepdim, "linear", torch.nanquantile)
nanmedian = eager_op(name="nanmedian")(_nanmedian_pure)
nanmedian.__doc__ = 'Median ignoring NaNs.'

def _quantile_pure(x, q, axis=None, keepdim=False, interpolation='linear'):
    return _quantile(x, q, axis, keepdim, interpolation, torch.quantile)
quantile = eager_op(name="quantile")(_quantile_pure)
quantile.__doc__ = 'Quantile(s) q in [0, 1] along `axis`.'

def _nanquantile_pure(x, q, axis=None, keepdim=False, interpolation='linear'):
    return _quantile(x, q, axis, keepdim, interpolation, torch.nanquantile)
nanquantile = eager_op(name="nanquantile")(_nanquantile_pure)
nanquantile.__doc__ = 'Quantile ignoring NaNs.'

def _bincount_pure(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=int(minlength))
bincount = eager_op(name="bincount")(_bincount_pure)
bincount.__doc__ = 'Count occurrences of each value in an int tensor.'

def _corrcoef_pure(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.T)
corrcoef = eager_op(name="corrcoef")(_corrcoef_pure)
corrcoef.__doc__ = 'Pearson correlation matrix of rows (or columns).'

def _histogram_pure(input, bins=100, min=0, max=0, density=False):
    flat = torch.reshape(input, (-1,))
    if builtins.float(min) == 0.0 and builtins.float(max) == 0.0:
        lo, hi = flat.min(), flat.max()
    else:
        lo, hi = builtins.float(min), builtins.float(max)
    t = torch.linspace(0, 1, int(bins) + 1, device=input.device)
    edges = lo + t * (hi - lo)
    idx = torch.clamp(torch.searchsorted(edges, flat, right=True) - 1,
                      0, int(bins) - 1)
    hist = torch.zeros((int(bins),), dtype=torch.int64,
                       device=input.device).index_add_(
        0, idx, torch.ones_like(idx))
    if density:
        width = (edges[1:] - edges[:-1]).to(torch.float32)
        return hist / (width * hist.sum())
    return hist
histogram = eager_op(name="histogram")(_histogram_pure)
histogram.__doc__ = 'Histogram with `bins` equal-width buckets over [min, max].'

def _zeros_pure(shape, dtype=None):
    return torch.zeros(builtins.tuple(int(s) for s in shape),
                       dtype=_dt(dtype) or torch.float32, device=_dev())
zeros = eager_op(name="zeros", factory=True)(_zeros_pure)
zeros.__doc__ = 'Zeros of `shape`.'

def _ones_pure(shape, dtype=None):
    return torch.ones(builtins.tuple(int(s) for s in shape),
                      dtype=_dt(dtype) or torch.float32, device=_dev())
ones = eager_op(name="ones", factory=True)(_ones_pure)
ones.__doc__ = 'Ones of `shape`.'

def _full_pure(shape, fill_value, dtype=None):
    dt = _dt(dtype)
    if dt is None:
        if builtins.isinstance(fill_value, bool):
            dt = torch.bool
        elif builtins.isinstance(fill_value, int):
            dt = torch.int64
        elif builtins.isinstance(fill_value, builtins.complex):
            dt = torch.complex64
        else:
            dt = torch.float32
    return torch.full(builtins.tuple(int(s) for s in shape), fill_value,
                      dtype=dt, device=_dev())
full = eager_op(name="full", factory=True)(_full_pure)
full.__doc__ = 'Constant tensor of `shape` filled with `fill_value`.'

def _zeros_like_pure(x, dtype=None):
    return torch.zeros_like(x, dtype=_dt(dtype))
zeros_like = eager_op(name="zeros_like")(_zeros_like_pure)
zeros_like.__doc__ = "Zeros with x's shape (and dtype unless overridden)."

def _ones_like_pure(x, dtype=None):
    return torch.ones_like(x, dtype=_dt(dtype))
ones_like = eager_op(name="ones_like")(_ones_like_pure)
ones_like.__doc__ = "Ones with x's shape."

def _full_like_pure(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=_dt(dtype))
full_like = eager_op(name="full_like")(_full_like_pure)
full_like.__doc__ = 'Constant tensor shaped like x.'

def _empty_pure(shape, dtype=None):
    return torch.zeros(builtins.tuple(int(s) for s in shape),
                       dtype=_dt(dtype) or torch.float32, device=_dev())
empty = eager_op(name="empty", factory=True)(_empty_pure)
empty.__doc__ = 'Uninitialized-contract tensor (deterministically zeros on XLA).'

def _empty_like_pure(x, dtype=None):
    return torch.zeros_like(x, dtype=_dt(dtype))
empty_like = eager_op(name="empty_like")(_empty_like_pure)
empty_like.__doc__ = 'Uninitialized-contract tensor shaped like x (zeros on XLA).'

def _arange_pure(start=0, end=None, step=1, dtype=None):
    lo, hi = (0, start) if end is None else (start, end)
    dt = _dt(dtype)
    if dt is None:
        isint = builtins.all(builtins.isinstance(v, int)
                             for v in (lo, hi, step))
        dt = torch.int64 if isint else torch.float32
    return torch.arange(lo, hi, step, dtype=dt, device=_dev())
arange = eager_op(name="arange", factory=True)(_arange_pure)
arange.__doc__ = 'Evenly spaced values in [start, end) with `step`.'

def _linspace_pure(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num),
                          dtype=_dt(dtype) or torch.float32, device=_dev())
linspace = eager_op(name="linspace", factory=True)(_linspace_pure)
linspace.__doc__ = 'num evenly spaced values from start to stop (inclusive).'

def _logspace_pure(start, stop, num, base=10.0, dtype=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=_dt(dtype) or torch.float32, device=_dev())
logspace = eager_op(name="logspace", factory=True)(_logspace_pure)
logspace.__doc__ = 'num log-spaced values base**start .. base**stop.'

def _eye_pure(num_rows, num_columns=None, dtype=None):
    return torch.eye(int(num_rows),
                     int(num_rows) if num_columns is None else int(num_columns),
                     dtype=_dt(dtype) or torch.float32, device=_dev())
eye = eager_op(name="eye", factory=True)(_eye_pure)
eye.__doc__ = 'Identity matrix.'

def _diag_pure(x, offset=0, padding_value=0):
    if x.ndim == 1:
        out = torch.diag(x, int(offset))
        if padding_value:
            mask = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
            out = torch.where(mask, out, torch.as_tensor(
                padding_value, dtype=x.dtype, device=x.device))
        return out
    return torch.diagonal(x, int(offset))
diag = eager_op(name="diag")(_diag_pure)
diag.__doc__ = 'Build a diagonal matrix from 1-D x, or extract a diagonal from 2-D.'

def _diagflat_pure(x, offset=0):
    return torch.diagflat(x, int(offset))
diagflat = eager_op(name="diagflat")(_diagflat_pure)
diagflat.__doc__ = 'Diagonal matrix from the flattened input.'

def _tril_pure(x, diagonal=0):
    return torch.tril(x, int(diagonal))
tril = eager_op(name="tril")(_tril_pure)
tril.__doc__ = 'Lower-triangular part (others zeroed).'

def _triu_pure(x, diagonal=0):
    return torch.triu(x, int(diagonal))
triu = eager_op(name="triu")(_triu_pure)
triu.__doc__ = 'Upper-triangular part (others zeroed).'

def _tril_indices_pure(row, col=None, offset=0, dtype='int64'):
    out = torch.tril_indices(int(row), int(col) if col is not None else int(row),
                             int(offset), device=_dev())
    return out.to(_dt(dtype))
tril_indices = eager_op(name="tril_indices", factory=True)(_tril_indices_pure)
tril_indices.__doc__ = '[2, n] row/col indices of the lower triangle.'

def _triu_indices_pure(row, col=None, offset=0, dtype='int64'):
    out = torch.triu_indices(int(row), int(col) if col is not None else int(row),
                             int(offset), device=_dev())
    return out.to(_dt(dtype))
triu_indices = eager_op(name="triu_indices", factory=True)(_triu_indices_pure)
triu_indices.__doc__ = '[2, n] row/col indices of the upper triangle.'

def _clone_pure(x):
    return x.clone()
clone = eager_op(name="clone")(_clone_pure)
clone.__doc__ = 'Copy (differentiable identity).'

def _complex_pure(real, imag):
    return torch.complex(real, imag)
complex = eager_op(name="complex")(_complex_pure)
complex.__doc__ = 'Build a complex tensor from real and imaginary parts.'

def _polar_pure(abs, angle):
    return torch.complex(abs * torch.cos(angle), abs * torch.sin(angle))
polar = eager_op(name="polar")(_polar_pure)
polar.__doc__ = 'Complex from magnitude and phase.'

def _matmul_pure(x, y, transpose_x=False, transpose_y=False):
    a = torch.swapaxes(x, -2, -1) if transpose_x and x.ndim >= 2 else x
    b = torch.swapaxes(y, -2, -1) if transpose_y and y.ndim >= 2 else y
    return torch.matmul(a, b)
matmul = eager_op(name="matmul")(_matmul_pure)
matmul.__doc__ = 'Batched matmul with optional transposes.'

def _mm_pure(x, y):
    return torch.matmul(x, y)
mm = eager_op(name="mm")(_mm_pure)
mm.__doc__ = 'Matrix multiply (no broadcast, paddle.mm).'

def _bmm_pure(x, y):
    return torch.matmul(x, y)
bmm = eager_op(name="bmm")(_bmm_pure)
bmm.__doc__ = 'Batched 3-D matmul.'

def _dot_pure(x, y):
    return torch.sum(x * y, dim=-1)
dot = eager_op(name="dot")(_dot_pure)
dot.__doc__ = 'Inner product over the last dim (paddle.dot — 1/2-D).'

def _mv_pure(x, vec):
    return torch.matmul(x, vec)
mv = eager_op(name="mv")(_mv_pure)
mv.__doc__ = 'Matrix-vector product.'

def _dist_pure(x, y, p=2.0):
    d = torch.abs(x - y)
    pf = builtins.float(p)
    if pf == builtins.float("inf"):
        return torch.amax(d)
    if pf == 0.0:
        return torch.sum((d != 0).to(x.dtype))
    return torch.sum(d ** pf) ** (1.0 / pf)
dist = eager_op(name="dist")(_dist_pure)
dist.__doc__ = 'p-norm of (x - y).'

def _cross_pure(x, y, axis=9):
    ax = int(axis)
    if ax == 9:
        dims = [i for i, s in builtins.enumerate(x.shape) if s == 3]
        ax = dims[0] if dims else -1
    return torch.linalg.cross(x, y, dim=ax)
cross = eager_op(name="cross")(_cross_pure)
cross.__doc__ = '3-D cross product along the first size-3 axis (paddle default).'

def _cholesky_pure(x, upper=False):
    L = torch.linalg.cholesky(x)
    return torch.swapaxes(L, -2, -1) if upper else L
cholesky = eager_op(name="cholesky")(_cholesky_pure)
cholesky.__doc__ = 'Cholesky factor of an SPD matrix.'

def _solve_pure(x, y):
    return torch.linalg.solve(x, y)
solve = eager_op(name="solve")(_solve_pure)
solve.__doc__ = 'Solve x @ out = y.'

def _triangular_solve_pure(x, y, upper=True, transpose=False, unitriangular=False):
    a = torch.swapaxes(x, -2, -1) if transpose else x
    up = builtins.bool(upper) != builtins.bool(transpose)
    return torch.linalg.solve_triangular(
        a, y, upper=up, unitriangular=builtins.bool(unitriangular))
triangular_solve = eager_op(name="triangular_solve")(_triangular_solve_pure)
triangular_solve.__doc__ = 'Solve a triangular system.'

def _cholesky_solve_pure(x, y, upper=False):
    L = torch.swapaxes(y, -2, -1) if upper else y
    z = torch.linalg.solve_triangular(L, x, upper=False)
    return torch.linalg.solve_triangular(
        torch.swapaxes(L, -2, -1), z, upper=True)
cholesky_solve = eager_op(name="cholesky_solve")(_cholesky_solve_pure)
cholesky_solve.__doc__ = "Solve A @ out = x given A's Cholesky factor y."

def _inverse_pure(x):
    return torch.linalg.inv(x)
inverse = eager_op(name="inverse")(_inverse_pure)
inverse.__doc__ = 'Matrix inverse.'

def _pinv_pure(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=builtins.bool(hermitian))
pinv = eager_op(name="pinv")(_pinv_pure)
pinv.__doc__ = 'Moore-Penrose pseudo-inverse.'

def _det_pure(x):
    return torch.linalg.det(x)
det = eager_op(name="det")(_det_pure)
det.__doc__ = 'Determinant.'

def _slogdet_pure(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])
slogdet = eager_op(name="slogdet")(_slogdet_pure)
slogdet.__doc__ = '[sign, log|det|] stacked (paddle returns a [2, ...] tensor).'

def _matrix_power_pure(x, n):
    return torch.linalg.matrix_power(x, int(n))
matrix_power = eager_op(name="matrix_power")(_matrix_power_pure)
matrix_power.__doc__ = 'Integer matrix power.'

def _matrix_rank_pure(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol)
matrix_rank = eager_op(name="matrix_rank")(_matrix_rank_pure)
matrix_rank.__doc__ = 'Rank by SVD thresholding.'

def _qr_pure(x, mode='reduced'):
    q, r = torch.linalg.qr(x, mode=mode)
    return q, r
qr = eager_op(name="qr")(_qr_pure)
qr.__doc__ = 'QR decomposition (reduced or complete).'

def _svd_pure(x, full_matrices=False):
    u, s, vh = torch.linalg.svd(x, full_matrices=builtins.bool(full_matrices))
    return u, s, vh
svd = eager_op(name="svd")(_svd_pure)
svd.__doc__ = 'Singular value decomposition (returns U, S, Vh).'

def _svdvals_pure(x):
    return torch.linalg.svdvals(x)
svdvals = eager_op(name="svdvals")(_svdvals_pure)
svdvals.__doc__ = 'Singular values only.'

def _eigh_pure(x, UPLO='L'):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v
eigh = eager_op(name="eigh")(_eigh_pure)
eigh.__doc__ = 'Eigendecomposition of a symmetric/hermitian matrix.'

def _eigvalsh_pure(x, UPLO='L'):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)
eigvalsh = eager_op(name="eigvalsh")(_eigvalsh_pure)
eigvalsh.__doc__ = 'Eigenvalues of a symmetric/hermitian matrix.'

def _multi_dot_pure(tensors):
    return torch.linalg.multi_dot(builtins.list(tensors))
multi_dot = eager_op(name="multi_dot")(_multi_dot_pure)
multi_dot.__doc__ = 'Optimal-order chain matmul over a list.'

def _tensordot_pure(x, y, axes=2):
    ax = axes
    if builtins.isinstance(ax, (builtins.list, builtins.tuple)):
        ax = [builtins.list(a) if builtins.isinstance(a, (builtins.list, builtins.tuple))
              else [a] for a in ax]
    return torch.tensordot(x, y, dims=ax)
tensordot = eager_op(name="tensordot")(_tensordot_pure)
tensordot.__doc__ = 'Generalized tensor contraction (numpy axes convention).'

def _cond_pure(x, p=None):
    if p not in (None, 2, 2.0):
        raise NotImplementedError(
            f"cond: only the 2-norm condition number is implemented "
            f"(got p={p!r})")
    s = torch.linalg.svdvals(x)
    return s[..., 0] / s[..., -1]
cond = eager_op(name="cond")(_cond_pure)
cond.__doc__ = '2-norm condition number via the singular-value ratio.'

def _vector_norm_pure(x, p=2.0, axis=None, keepdim=False):
    d = torch.abs(x)
    pf = builtins.float(p)
    ax = _dims(x, axis)
    if pf == builtins.float("inf"):
        return torch.amax(d, dim=ax, keepdim=builtins.bool(keepdim))
    if pf == 0.0:
        return torch.sum((x != 0).to(x.dtype), dim=ax,
                         keepdim=builtins.bool(keepdim))
    return torch.sum(d ** pf, dim=ax,
                     keepdim=builtins.bool(keepdim)) ** (1.0 / pf)
vector_norm = eager_op(name="vector_norm")(_vector_norm_pure)
vector_norm.__doc__ = 'Vector p-norm along `axis` (paddle.linalg.vector_norm).'

def _matrix_norm_pure(x, p='fro', axis=(-2, -1), keepdim=False):
    return torch.linalg.matrix_norm(x, ord=p, dim=builtins.tuple(axis),
                                   keepdim=builtins.bool(keepdim))
matrix_norm = eager_op(name="matrix_norm")(_matrix_norm_pure)
matrix_norm.__doc__ = "Matrix norm over the trailing two dims ('fro', 1, inf, ...)."

def _householder_product_pure(x, tau):
    return torch.linalg.householder_product(x, tau)
householder_product = eager_op(name="householder_product")(_householder_product_pure)
householder_product.__doc__ = 'Assemble Q from Householder reflectors (geqrf convention).'

def _relu_pure(x):
    return torch.relu(x)
relu = eager_op(name="relu")(_relu_pure)
relu.__doc__ = 'max(x, 0).'

def _relu6_pure(x):
    return torch.clamp(x, 0, 6)
relu6 = eager_op(name="relu6")(_relu6_pure)
relu6.__doc__ = 'min(max(x, 0), 6).'

def _elu_pure(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(x))
elu = eager_op(name="elu")(_elu_pure)
elu.__doc__ = 'x if x > 0 else alpha * (exp(x) - 1).'

def _celu_pure(x, alpha=1.0):
    return torch.clamp_min(x, 0) + torch.clamp_max(alpha * torch.expm1(x / alpha), 0)
celu = eager_op(name="celu")(_celu_pure)
celu.__doc__ = 'Continuously differentiable ELU.'

def _selu_pure(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
selu = eager_op(name="selu")(_selu_pure)
selu.__doc__ = 'Self-normalizing ELU.'

def _gelu_pure(x, approximate=False):
    return torch.nn.functional.gelu(x, approximate="tanh" if approximate else "none")
gelu = eager_op(name="gelu")(_gelu_pure)
gelu.__doc__ = 'Gaussian error linear unit (erf form; tanh when approximate).'

def _silu_pure(x):
    return x * torch.sigmoid(x)
silu = eager_op(name="silu")(_silu_pure)
silu.__doc__ = 'x * sigmoid(x) (a.k.a. swish).'

def _swish_pure(x):
    return x * torch.sigmoid(x)
swish = eager_op(name="swish")(_swish_pure)
swish.__doc__ = 'Alias of silu.'

def _mish_pure(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))
mish = eager_op(name="mish")(_mish_pure)
mish.__doc__ = 'x * tanh(softplus(x)).'

def _softplus_pure(x, beta=1.0, threshold=20.0):
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.log1p(torch.exp(scaled)) / beta)
softplus = eager_op(name="softplus")(_softplus_pure)
softplus.__doc__ = 'log(1 + exp(beta x)) / beta with linear overflow guard.'

def _softsign_pure(x):
    return x / (1 + torch.abs(x))
softsign = eager_op(name="softsign")(_softsign_pure)
softsign.__doc__ = 'x / (1 + |x|).'

def _softshrink_pure(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold, torch.where(x < -threshold, x + threshold, 0.0))
softshrink = eager_op(name="softshrink")(_softshrink_pure)
softshrink.__doc__ = 'Shrink toward zero by `threshold`.'

def _hardshrink_pure(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, 0.0)
hardshrink = eager_op(name="hardshrink")(_hardshrink_pure)
hardshrink.__doc__ = 'Zero inside [-threshold, threshold].'

def _hardtanh_pure(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)
hardtanh = eager_op(name="hardtanh")(_hardtanh_pure)
hardtanh.__doc__ = 'Clip to [min, max].'

def _hardsigmoid_pure(x, slope=0.1666667, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)
hardsigmoid = eager_op(name="hardsigmoid")(_hardsigmoid_pure)
hardsigmoid.__doc__ = 'Piecewise-linear sigmoid.'

def _hardswish_pure(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0
hardswish = eager_op(name="hardswish")(_hardswish_pure)
hardswish.__doc__ = 'x * relu6(x + 3) / 6.'

def _leaky_relu_pure(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)
leaky_relu = eager_op(name="leaky_relu")(_leaky_relu_pure)
leaky_relu.__doc__ = 'x if x >= 0 else slope * x.'

def _log_sigmoid_pure(x):
    return torch.nn.functional.logsigmoid(x)
log_sigmoid = eager_op(name="log_sigmoid")(_log_sigmoid_pure)
log_sigmoid.__doc__ = 'log(sigmoid(x)), numerically stable.'

def _tanhshrink_pure(x):
    return x - torch.tanh(x)
tanhshrink = eager_op(name="tanhshrink")(_tanhshrink_pure)
tanhshrink.__doc__ = 'x - tanh(x).'

def _thresholded_relu_pure(x, threshold=1.0):
    return torch.where(x > threshold, x, 0.0)
thresholded_relu = eager_op(name="thresholded_relu")(_thresholded_relu_pure)
thresholded_relu.__doc__ = 'x where x > threshold else 0.'

def _prelu_pure(x, weight):
    return torch.where(x >= 0, x, weight * x)
prelu = eager_op(name="prelu")(_prelu_pure)
prelu.__doc__ = 'Parametric ReLU (weight broadcasts over x).'

def _glu_pure(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=int(axis))
    return a * torch.sigmoid(b)
glu = eager_op(name="glu")(_glu_pure)
glu.__doc__ = 'Gated linear unit, halves along `axis`.'

def _softmax_pure(x, axis=-1):
    return torch.softmax(x, dim=int(axis))
softmax = eager_op(name="softmax")(_softmax_pure)
softmax.__doc__ = 'Softmax along `axis`.'

def _log_softmax_pure(x, axis=-1):
    return torch.log_softmax(x, dim=int(axis))
log_softmax = eager_op(name="log_softmax")(_log_softmax_pure)
log_softmax.__doc__ = 'log(softmax(x)) along `axis`, numerically stable.'

def _sgn_pure(x):
    return torch.sgn(x)
sgn = eager_op(name="sgn")(_sgn_pure)
sgn.__doc__ = 'Complex-aware sign (unit phase for complex, sign for real).'

def _frexp_pure(x):
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)
frexp = eager_op(name="frexp")(_frexp_pure)
frexp.__doc__ = '(mantissa, exponent) with x = m * 2**e.'

def _cummax_pure(x, axis=None):
    return _cumext(x, axis, torch.cummax)
cummax = eager_op(name="cummax")(_cummax_pure)
cummax.__doc__ = '(values, indices) running maximum along `axis`.'

def _cummin_pure(x, axis=None):
    return _cumext(x, axis, torch.cummin)
cummin = eager_op(name="cummin")(_cummin_pure)
cummin.__doc__ = '(values, indices) running minimum along `axis`.'

def _isreal_pure(x):
    if x.is_complex():
        return torch.imag(x) == 0
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)
isreal = eager_op(name="isreal")(_isreal_pure)
isreal.__doc__ = 'True where the imaginary part is zero.'

def _fft_pure(x, n=None, axis=-1, norm='backward'):
    return torch.fft.fft(x, n, int(axis), norm)
fft = eager_op(name="fft")(_fft_pure)
fft.__doc__ = '1-D discrete Fourier transform.'

def _ifft_pure(x, n=None, axis=-1, norm='backward'):
    return torch.fft.ifft(x, n, int(axis), norm)
ifft = eager_op(name="ifft")(_ifft_pure)
ifft.__doc__ = 'Inverse 1-D DFT.'

def _fft2_pure(x, s=None, axes=(-2, -1), norm='backward'):
    return torch.fft.fft2(x, s, builtins.tuple(axes), norm)
fft2 = eager_op(name="fft2")(_fft2_pure)
fft2.__doc__ = '2-D DFT over `axes`.'

def _ifft2_pure(x, s=None, axes=(-2, -1), norm='backward'):
    return torch.fft.ifft2(x, s, builtins.tuple(axes), norm)
ifft2 = eager_op(name="ifft2")(_ifft2_pure)
ifft2.__doc__ = 'Inverse 2-D DFT.'

def _fftn_pure(x, s=None, axes=None, norm='backward'):
    return torch.fft.fftn(x, s, None if axes is None else builtins.tuple(axes), norm)
fftn = eager_op(name="fftn")(_fftn_pure)
fftn.__doc__ = 'N-D DFT.'

def _ifftn_pure(x, s=None, axes=None, norm='backward'):
    return torch.fft.ifftn(x, s, None if axes is None else builtins.tuple(axes), norm)
ifftn = eager_op(name="ifftn")(_ifftn_pure)
ifftn.__doc__ = 'Inverse N-D DFT.'

def _rfft_pure(x, n=None, axis=-1, norm='backward'):
    return torch.fft.rfft(x, n, int(axis), norm)
rfft = eager_op(name="rfft")(_rfft_pure)
rfft.__doc__ = 'Real-input 1-D DFT (half spectrum).'

def _irfft_pure(x, n=None, axis=-1, norm='backward'):
    return torch.fft.irfft(x, n, int(axis), norm)
irfft = eager_op(name="irfft")(_irfft_pure)
irfft.__doc__ = 'Inverse of rfft back to the real domain.'

def _rfft2_pure(x, s=None, axes=(-2, -1), norm='backward'):
    return torch.fft.rfft2(x, s, builtins.tuple(axes), norm)
rfft2 = eager_op(name="rfft2")(_rfft2_pure)
rfft2.__doc__ = 'Real-input 2-D DFT.'

def _irfft2_pure(x, s=None, axes=(-2, -1), norm='backward'):
    return torch.fft.irfft2(x, s, builtins.tuple(axes), norm)
irfft2 = eager_op(name="irfft2")(_irfft2_pure)
irfft2.__doc__ = 'Inverse real 2-D DFT.'

def _rfftn_pure(x, s=None, axes=None, norm='backward'):
    return torch.fft.rfftn(x, s, None if axes is None else builtins.tuple(axes), norm)
rfftn = eager_op(name="rfftn")(_rfftn_pure)
rfftn.__doc__ = 'Real-input N-D DFT.'

def _irfftn_pure(x, s=None, axes=None, norm='backward'):
    return torch.fft.irfftn(x, s, None if axes is None else builtins.tuple(axes), norm)
irfftn = eager_op(name="irfftn")(_irfftn_pure)
irfftn.__doc__ = 'Inverse real N-D DFT.'

def _hfft_pure(x, n=None, axis=-1, norm='backward'):
    return torch.fft.hfft(x, n, int(axis), norm)
hfft = eager_op(name="hfft")(_hfft_pure)
hfft.__doc__ = 'DFT of a hermitian-symmetric signal (real output).'

def _ihfft_pure(x, n=None, axis=-1, norm='backward'):
    return torch.fft.ihfft(x, n, int(axis), norm)
ihfft = eager_op(name="ihfft")(_ihfft_pure)
ihfft.__doc__ = 'Inverse hermitian DFT.'

def _fftshift_pure(x, axes=None):
    return torch.fft.fftshift(x, None if axes is None else _axis(axes))
fftshift = eager_op(name="fftshift")(_fftshift_pure)
fftshift.__doc__ = 'Shift the zero-frequency component to the center.'

def _ifftshift_pure(x, axes=None):
    return torch.fft.ifftshift(x, None if axes is None else _axis(axes))
ifftshift = eager_op(name="ifftshift")(_ifftshift_pure)
ifftshift.__doc__ = 'Inverse of fftshift.'

def _fftfreq_pure(n, d=1.0, dtype=None):
    return torch.fft.fftfreq(int(n), d, dtype=_dt(dtype) or torch.float32,
                             device=_dev())
fftfreq = eager_op(name="fftfreq", factory=True)(_fftfreq_pure)
fftfreq.__doc__ = 'DFT sample frequencies.'

def _rfftfreq_pure(n, d=1.0, dtype=None):
    return torch.fft.rfftfreq(int(n), d, dtype=_dt(dtype) or torch.float32,
                              device=_dev())
rfftfreq = eager_op(name="rfftfreq", factory=True)(_rfftfreq_pure)
rfftfreq.__doc__ = 'rfft sample frequencies.'

def _slice_pure(x, axes, starts, ends):
    sl = [builtins.slice(None)] * x.ndim
    for a, st, en in builtins.zip(axes, starts, ends):
        sl[int(a)] = builtins.slice(int(st), int(en))
    return x[builtins.tuple(sl)]
slice = eager_op(name="slice")(_slice_pure)
slice.__doc__ = 'Static slice on the named `axes` (paddle.slice).'

def _strided_slice_pure(x, axes, starts, ends, strides):
    for a, st, en, sd in builtins.zip(axes, starts, ends, strides):
        x = _strided(x, int(a), int(st), int(en), int(sd))
    return x
strided_slice = eager_op(name="strided_slice")(_strided_slice_pure)
strided_slice.__doc__ = 'Static strided slice on the named `axes`.'

def _select_scatter_pure(x, values, axis, index):
    return torch.select_scatter(x, values, int(axis), int(index))
select_scatter = eager_op(name="select_scatter")(_select_scatter_pure)
select_scatter.__doc__ = 'Write `values` into the `index` slice along `axis`.'

def _slice_scatter_pure(x, value, axes, starts, ends, strides):
    idx = torch.arange(x.numel(), device=x.device).reshape(x.shape)
    for a, st, en, sd in builtins.zip(axes, starts, ends, strides):
        idx = _strided(idx, int(a), int(st), int(en), int(sd))
    return torch.reshape(x, (-1,)).index_put(
        (torch.reshape(idx, (-1,)),), torch.reshape(
            torch.broadcast_to(value, idx.shape), (-1,))).reshape(x.shape)
slice_scatter = eager_op(name="slice_scatter")(_slice_scatter_pure)
slice_scatter.__doc__ = 'Write `value` into a strided slice of x.'

def _unfold_pure(x, axis, size, step):
    ax = int(axis) % x.ndim
    return x.unfold(ax, int(size), int(step))
unfold = eager_op(name="unfold")(_unfold_pure)
unfold.__doc__ = 'Sliding windows of `size` every `step` along `axis` (tensor.unfold).'

# -- schema registry (the sharding hints, signatures and custom-VJP marks) --
OP_INFO = {
    "add": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "subtract": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "multiply": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "divide": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "floor_divide": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "remainder": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "pow": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "maximum": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "minimum": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "fmax": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "fmin": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "atan2": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "heaviside": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "gcd": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "lcm": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "hypot": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logaddexp": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logaddexp2": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "copysign": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "nextafter": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "ldexp": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "inner": {"args": ['x', 'y'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "outer": {"args": ['x', 'y'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "kron": {"args": ['x', 'y'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "lerp": {"args": ['x', 'y', 'weight'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "exp": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "expm1": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "exp2": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "log": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "log2": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "log10": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "log1p": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "sqrt": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "rsqrt": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": True},
    "reciprocal": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": True},
    "abs": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "square": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": True},
    "ceil": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "floor": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "round": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "trunc": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "frac": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "sign": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "sin": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "cos": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "tan": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "asin": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "acos": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "atan": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "sinh": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "cosh": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "tanh": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "asinh": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "acosh": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "atanh": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "erf": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "erfc": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "erfinv": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "lgamma": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "digamma": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "polygamma": {"args": ['x'], "attrs": {'n': '<required>'}, "sharding": 'elementwise', "custom_vjp": False},
    "i0": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "i0e": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "i1": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "i1e": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "neg": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "deg2rad": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "rad2deg": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "angle": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "conj": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "real": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "imag": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "isnan": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "isinf": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "isfinite": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "sigmoid": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logit": {"args": ['x'], "attrs": {'eps': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "stanh": {"args": ['x'], "attrs": {'scale_a': '0.67', 'scale_b': '1.7159'}, "sharding": 'elementwise', "custom_vjp": False},
    "nan_to_num": {"args": ['x'], "attrs": {'nan': '0.0', 'posinf': 'None', 'neginf': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "clip": {"args": ['x'], "attrs": {'min': 'None', 'max': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "scale": {"args": ['x'], "attrs": {'scale': '1.0', 'bias': '0.0', 'bias_after_scale': 'True', 'act': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "increment": {"args": ['x'], "attrs": {'value': '1.0'}, "sharding": 'elementwise', "custom_vjp": False},
    "sum": {"args": ['x'], "attrs": {'axis': 'None', 'dtype': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "mean": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "max": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "min": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "amax": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "amin": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "prod": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False', 'dtype': 'None'}, "sharding": 'reduction', "custom_vjp": False},
    "logsumexp": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "count_nonzero": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "nansum": {"args": ['x'], "attrs": {'axis': 'None', 'dtype': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "nanmean": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "all": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "any": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "cumsum": {"args": ['x'], "attrs": {'axis': 'None', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "cumprod": {"args": ['x'], "attrs": {'dim': 'None', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "logcumsumexp": {"args": ['x'], "attrs": {'axis': 'None'}, "sharding": 'special', "custom_vjp": False},
    "trace": {"args": ['x'], "attrs": {'offset': '0', 'axis1': '0', 'axis2': '1'}, "sharding": 'special', "custom_vjp": False},
    "diagonal": {"args": ['x'], "attrs": {'offset': '0', 'axis1': '0', 'axis2': '1'}, "sharding": 'special', "custom_vjp": False},
    "addmm": {"args": ['input', 'x', 'y'], "attrs": {'beta': '1.0', 'alpha': '1.0'}, "sharding": 'contraction', "custom_vjp": False},
    "diff": {"args": ['x'], "attrs": {'n': '1', 'axis': '-1', 'prepend': 'None', 'append': 'None'}, "sharding": 'special', "custom_vjp": False},
    "equal": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "not_equal": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "greater_than": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "greater_equal": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "less_than": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "less_equal": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logical_and": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logical_or": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logical_xor": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "logical_not": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "isclose": {"args": ['x', 'y'], "attrs": {'rtol': '1e-05', 'atol': '1e-08', 'equal_nan': 'False'}, "sharding": 'elementwise', "custom_vjp": False},
    "allclose": {"args": ['x', 'y'], "attrs": {'rtol': '1e-05', 'atol': '1e-08', 'equal_nan': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "equal_all": {"args": ['x', 'y'], "attrs": {}, "sharding": 'reduction', "custom_vjp": False},
    "bitwise_and": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "bitwise_or": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "bitwise_xor": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "bitwise_not": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "bitwise_left_shift": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "bitwise_right_shift": {"args": ['x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "signbit": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "sinc": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "take": {"args": ['x', 'index'], "attrs": {'mode': "'raise'"}, "sharding": 'special', "custom_vjp": False},
    "isin": {"args": ['x', 'test_x'], "attrs": {'assume_unique': 'False', 'invert': 'False'}, "sharding": 'elementwise', "custom_vjp": False},
    "vander": {"args": ['x'], "attrs": {'n': 'None', 'increasing': 'False'}, "sharding": 'special', "custom_vjp": False},
    "trapezoid": {"args": ['y'], "attrs": {'x': 'None', 'dx': 'None', 'axis': '-1'}, "sharding": 'reduction', "custom_vjp": False},
    "cdist": {"args": ['x', 'y'], "attrs": {'p': '2.0', 'compute_mode': "'use_mm_for_euclid_dist_if_necessary'"}, "sharding": 'contraction', "custom_vjp": False},
    "diag_embed": {"args": ['x'], "attrs": {'offset': '0', 'dim1': '-2', 'dim2': '-1'}, "sharding": 'special', "custom_vjp": False},
    "fill_diagonal": {"args": ['x'], "attrs": {'value': '0.0', 'offset': '0', 'wrap': 'False'}, "sharding": 'special', "custom_vjp": False},
    "reshape": {"args": ['x'], "attrs": {'shape': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "cast": {"args": ['x'], "attrs": {'dtype': '<required>'}, "sharding": 'elementwise', "custom_vjp": False},
    "flatten": {"args": ['x'], "attrs": {'start_axis': '0', 'stop_axis': '-1'}, "sharding": 'special', "custom_vjp": False},
    "transpose": {"args": ['x'], "attrs": {'perm': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "moveaxis": {"args": ['x'], "attrs": {'source': '<required>', 'destination': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "swapaxes": {"args": ['x'], "attrs": {'axis0': '<required>', 'axis1': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "t": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "matrix_transpose": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "squeeze": {"args": ['x'], "attrs": {'axis': 'None'}, "sharding": 'special', "custom_vjp": False},
    "unsqueeze": {"args": ['x'], "attrs": {'axis': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "concat": {"args": ['x'], "attrs": {'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "stack": {"args": ['x'], "attrs": {'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "unstack": {"args": ['x'], "attrs": {'axis': '0', 'num': 'None'}, "sharding": 'special', "custom_vjp": False},
    "split": {"args": ['x'], "attrs": {'num_or_sections': '<required>', 'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "chunk": {"args": ['x'], "attrs": {'chunks': '<required>', 'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "tensor_split": {"args": ['x'], "attrs": {'num_or_indices': '<required>', 'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "hsplit": {"args": ['x'], "attrs": {'num_or_indices': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "vsplit": {"args": ['x'], "attrs": {'num_or_indices': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "dsplit": {"args": ['x'], "attrs": {'num_or_indices': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "tile": {"args": ['x'], "attrs": {'repeat_times': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "expand": {"args": ['x'], "attrs": {'shape': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "expand_as": {"args": ['x', 'y'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "broadcast_to": {"args": ['x'], "attrs": {'shape': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "flip": {"args": ['x'], "attrs": {'axis': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "rot90": {"args": ['x'], "attrs": {'k': '1', 'axes': '(0, 1)'}, "sharding": 'special', "custom_vjp": False},
    "roll": {"args": ['x'], "attrs": {'shifts': '<required>', 'axis': 'None'}, "sharding": 'special', "custom_vjp": False},
    "gather": {"args": ['x', 'index'], "attrs": {'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "gather_nd": {"args": ['x', 'index'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "index_select": {"args": ['x', 'index'], "attrs": {'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "index_sample": {"args": ['x', 'index'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "index_add": {"args": ['x', 'index', 'value'], "attrs": {'axis': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "take_along_axis": {"args": ['arr', 'indices'], "attrs": {'axis': '<required>', 'broadcast': 'True'}, "sharding": 'special', "custom_vjp": False},
    "put_along_axis": {"args": ['arr', 'indices', 'values'], "attrs": {'axis': '<required>', 'reduce': "'assign'"}, "sharding": 'special', "custom_vjp": False},
    "scatter": {"args": ['x', 'index', 'updates'], "attrs": {'overwrite': 'True'}, "sharding": 'special', "custom_vjp": False},
    "scatter_nd": {"args": ['index', 'updates'], "attrs": {'shape': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "scatter_nd_add": {"args": ['x', 'index', 'updates'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "masked_fill": {"args": ['x', 'mask', 'value'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "where": {"args": ['condition', 'x', 'y'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "repeat_interleave": {"args": ['x'], "attrs": {'repeats': '<required>', 'axis': 'None'}, "sharding": 'special', "custom_vjp": False},
    "unbind": {"args": ['x'], "attrs": {'axis': '0'}, "sharding": 'special', "custom_vjp": False},
    "as_complex": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "as_real": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "crop": {"args": ['x'], "attrs": {'shape': 'None', 'offsets': 'None'}, "sharding": 'special', "custom_vjp": False},
    "atleast_1d": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "atleast_2d": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "atleast_3d": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "hstack": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "vstack": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "dstack": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "column_stack": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "row_stack": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "numel": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "unflatten": {"args": ['x'], "attrs": {'axis': '<required>', 'shape': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "diagonal_scatter": {"args": ['x', 'y'], "attrs": {'offset': '0', 'axis1': '0', 'axis2': '1'}, "sharding": 'special', "custom_vjp": False},
    "shard_index": {"args": ['input'], "attrs": {'index_num': '<required>', 'nshards': '<required>', 'shard_id': '<required>', 'ignore_value': '-1'}, "sharding": 'elementwise', "custom_vjp": False},
    "argmax": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False', 'dtype': "'int64'"}, "sharding": 'reduction', "custom_vjp": False},
    "argmin": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False', 'dtype': "'int64'"}, "sharding": 'reduction', "custom_vjp": False},
    "argsort": {"args": ['x'], "attrs": {'axis': '-1', 'descending': 'False', 'stable': 'True'}, "sharding": 'special', "custom_vjp": False},
    "sort": {"args": ['x'], "attrs": {'axis': '-1', 'descending': 'False', 'stable': 'True'}, "sharding": 'special', "custom_vjp": False},
    "topk": {"args": ['x'], "attrs": {'k': '<required>', 'axis': 'None', 'largest': 'True', 'sorted': 'True'}, "sharding": 'special', "custom_vjp": False},
    "kthvalue": {"args": ['x'], "attrs": {'k': '<required>', 'axis': '-1', 'keepdim': 'False'}, "sharding": 'special', "custom_vjp": False},
    "searchsorted": {"args": ['sorted_sequence', 'values'], "attrs": {'out_int32': 'False', 'right': 'False'}, "sharding": 'special', "custom_vjp": False},
    "bucketize": {"args": ['x', 'sorted_sequence'], "attrs": {'out_int32': 'False', 'right': 'False'}, "sharding": 'special', "custom_vjp": False},
    "index_fill": {"args": ['x', 'index'], "attrs": {'axis': '<required>', 'value': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "var": {"args": ['x'], "attrs": {'axis': 'None', 'unbiased': 'True', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "std": {"args": ['x'], "attrs": {'axis': 'None', 'unbiased': 'True', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "median": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False', 'mode': "'avg'"}, "sharding": 'reduction', "custom_vjp": False},
    "nanmedian": {"args": ['x'], "attrs": {'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "quantile": {"args": ['x'], "attrs": {'q': '<required>', 'axis': 'None', 'keepdim': 'False', 'interpolation': "'linear'"}, "sharding": 'reduction', "custom_vjp": False},
    "nanquantile": {"args": ['x'], "attrs": {'q': '<required>', 'axis': 'None', 'keepdim': 'False', 'interpolation': "'linear'"}, "sharding": 'reduction', "custom_vjp": False},
    "bincount": {"args": ['x'], "attrs": {'weights': 'None', 'minlength': '0'}, "sharding": 'special', "custom_vjp": False},
    "corrcoef": {"args": ['x'], "attrs": {'rowvar': 'True'}, "sharding": 'special', "custom_vjp": False},
    "histogram": {"args": ['input'], "attrs": {'bins': '100', 'min': '0', 'max': '0', 'density': 'False'}, "sharding": 'special', "custom_vjp": False},
    "zeros": {"args": [], "attrs": {'shape': '<required>', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "ones": {"args": [], "attrs": {'shape': '<required>', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "full": {"args": [], "attrs": {'shape': '<required>', 'fill_value': '<required>', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "zeros_like": {"args": ['x'], "attrs": {'dtype': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "ones_like": {"args": ['x'], "attrs": {'dtype': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "full_like": {"args": ['x'], "attrs": {'fill_value': '<required>', 'dtype': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "empty": {"args": [], "attrs": {'shape': '<required>', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "empty_like": {"args": ['x'], "attrs": {'dtype': 'None'}, "sharding": 'elementwise', "custom_vjp": False},
    "arange": {"args": [], "attrs": {'start': '0', 'end': 'None', 'step': '1', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "linspace": {"args": [], "attrs": {'start': '<required>', 'stop': '<required>', 'num': '<required>', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "logspace": {"args": [], "attrs": {'start': '<required>', 'stop': '<required>', 'num': '<required>', 'base': '10.0', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "eye": {"args": [], "attrs": {'num_rows': '<required>', 'num_columns': 'None', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "diag": {"args": ['x'], "attrs": {'offset': '0', 'padding_value': '0'}, "sharding": 'special', "custom_vjp": False},
    "diagflat": {"args": ['x'], "attrs": {'offset': '0'}, "sharding": 'special', "custom_vjp": False},
    "tril": {"args": ['x'], "attrs": {'diagonal': '0'}, "sharding": 'elementwise', "custom_vjp": False},
    "triu": {"args": ['x'], "attrs": {'diagonal': '0'}, "sharding": 'elementwise', "custom_vjp": False},
    "tril_indices": {"args": [], "attrs": {'row': '<required>', 'col': 'None', 'offset': '0', 'dtype': "'int64'"}, "sharding": 'special', "custom_vjp": False},
    "triu_indices": {"args": [], "attrs": {'row': '<required>', 'col': 'None', 'offset': '0', 'dtype': "'int64'"}, "sharding": 'special', "custom_vjp": False},
    "clone": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "complex": {"args": ['real', 'imag'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "polar": {"args": ['abs', 'angle'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "matmul": {"args": ['x', 'y'], "attrs": {'transpose_x': 'False', 'transpose_y': 'False'}, "sharding": 'contraction', "custom_vjp": False},
    "mm": {"args": ['x', 'y'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "bmm": {"args": ['x', 'y'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "dot": {"args": ['x', 'y'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "mv": {"args": ['x', 'vec'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "dist": {"args": ['x', 'y'], "attrs": {'p': '2.0'}, "sharding": 'reduction', "custom_vjp": False},
    "cross": {"args": ['x', 'y'], "attrs": {'axis': '9'}, "sharding": 'special', "custom_vjp": False},
    "cholesky": {"args": ['x'], "attrs": {'upper': 'False'}, "sharding": 'special', "custom_vjp": False},
    "solve": {"args": ['x', 'y'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "triangular_solve": {"args": ['x', 'y'], "attrs": {'upper': 'True', 'transpose': 'False', 'unitriangular': 'False'}, "sharding": 'special', "custom_vjp": False},
    "cholesky_solve": {"args": ['x', 'y'], "attrs": {'upper': 'False'}, "sharding": 'special', "custom_vjp": False},
    "inverse": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "pinv": {"args": ['x'], "attrs": {'rcond': '1e-15', 'hermitian': 'False'}, "sharding": 'special', "custom_vjp": False},
    "det": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "slogdet": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "matrix_power": {"args": ['x'], "attrs": {'n': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "matrix_rank": {"args": ['x'], "attrs": {'tol': 'None', 'hermitian': 'False'}, "sharding": 'special', "custom_vjp": False},
    "qr": {"args": ['x'], "attrs": {'mode': "'reduced'"}, "sharding": 'special', "custom_vjp": False},
    "svd": {"args": ['x'], "attrs": {'full_matrices': 'False'}, "sharding": 'special', "custom_vjp": False},
    "svdvals": {"args": ['x'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "eigh": {"args": ['x'], "attrs": {'UPLO': "'L'"}, "sharding": 'special', "custom_vjp": False},
    "eigvalsh": {"args": ['x'], "attrs": {'UPLO': "'L'"}, "sharding": 'special', "custom_vjp": False},
    "multi_dot": {"args": ['tensors'], "attrs": {}, "sharding": 'contraction', "custom_vjp": False},
    "tensordot": {"args": ['x', 'y'], "attrs": {'axes': '2'}, "sharding": 'contraction', "custom_vjp": False},
    "cond": {"args": ['x'], "attrs": {'p': 'None'}, "sharding": 'special', "custom_vjp": False},
    "vector_norm": {"args": ['x'], "attrs": {'p': '2.0', 'axis': 'None', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "matrix_norm": {"args": ['x'], "attrs": {'p': "'fro'", 'axis': '(-2, -1)', 'keepdim': 'False'}, "sharding": 'reduction', "custom_vjp": False},
    "householder_product": {"args": ['x', 'tau'], "attrs": {}, "sharding": 'special', "custom_vjp": False},
    "relu": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "relu6": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "elu": {"args": ['x'], "attrs": {'alpha': '1.0'}, "sharding": 'elementwise', "custom_vjp": False},
    "celu": {"args": ['x'], "attrs": {'alpha': '1.0'}, "sharding": 'elementwise', "custom_vjp": False},
    "selu": {"args": ['x'], "attrs": {'scale': '1.0507009873554805', 'alpha': '1.6732632423543772'}, "sharding": 'elementwise', "custom_vjp": False},
    "gelu": {"args": ['x'], "attrs": {'approximate': 'False'}, "sharding": 'elementwise', "custom_vjp": False},
    "silu": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "swish": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "mish": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "softplus": {"args": ['x'], "attrs": {'beta': '1.0', 'threshold': '20.0'}, "sharding": 'elementwise', "custom_vjp": False},
    "softsign": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "softshrink": {"args": ['x'], "attrs": {'threshold': '0.5'}, "sharding": 'elementwise', "custom_vjp": False},
    "hardshrink": {"args": ['x'], "attrs": {'threshold': '0.5'}, "sharding": 'elementwise', "custom_vjp": False},
    "hardtanh": {"args": ['x'], "attrs": {'min': '-1.0', 'max': '1.0'}, "sharding": 'elementwise', "custom_vjp": False},
    "hardsigmoid": {"args": ['x'], "attrs": {'slope': '0.1666667', 'offset': '0.5'}, "sharding": 'elementwise', "custom_vjp": False},
    "hardswish": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "leaky_relu": {"args": ['x'], "attrs": {'negative_slope': '0.01'}, "sharding": 'elementwise', "custom_vjp": False},
    "log_sigmoid": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "tanhshrink": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "thresholded_relu": {"args": ['x'], "attrs": {'threshold': '1.0'}, "sharding": 'elementwise', "custom_vjp": False},
    "prelu": {"args": ['x', 'weight'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "glu": {"args": ['x'], "attrs": {'axis': '-1'}, "sharding": 'elementwise', "custom_vjp": False},
    "softmax": {"args": ['x'], "attrs": {'axis': '-1'}, "sharding": 'special', "custom_vjp": False},
    "log_softmax": {"args": ['x'], "attrs": {'axis': '-1'}, "sharding": 'special', "custom_vjp": False},
    "sgn": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "frexp": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "cummax": {"args": ['x'], "attrs": {'axis': 'None'}, "sharding": 'special', "custom_vjp": False},
    "cummin": {"args": ['x'], "attrs": {'axis': 'None'}, "sharding": 'special', "custom_vjp": False},
    "isreal": {"args": ['x'], "attrs": {}, "sharding": 'elementwise', "custom_vjp": False},
    "fft": {"args": ['x'], "attrs": {'n': 'None', 'axis': '-1', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "ifft": {"args": ['x'], "attrs": {'n': 'None', 'axis': '-1', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "fft2": {"args": ['x'], "attrs": {'s': 'None', 'axes': '(-2, -1)', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "ifft2": {"args": ['x'], "attrs": {'s': 'None', 'axes': '(-2, -1)', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "fftn": {"args": ['x'], "attrs": {'s': 'None', 'axes': 'None', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "ifftn": {"args": ['x'], "attrs": {'s': 'None', 'axes': 'None', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "rfft": {"args": ['x'], "attrs": {'n': 'None', 'axis': '-1', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "irfft": {"args": ['x'], "attrs": {'n': 'None', 'axis': '-1', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "rfft2": {"args": ['x'], "attrs": {'s': 'None', 'axes': '(-2, -1)', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "irfft2": {"args": ['x'], "attrs": {'s': 'None', 'axes': '(-2, -1)', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "rfftn": {"args": ['x'], "attrs": {'s': 'None', 'axes': 'None', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "irfftn": {"args": ['x'], "attrs": {'s': 'None', 'axes': 'None', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "hfft": {"args": ['x'], "attrs": {'n': 'None', 'axis': '-1', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "ihfft": {"args": ['x'], "attrs": {'n': 'None', 'axis': '-1', 'norm': "'backward'"}, "sharding": 'special', "custom_vjp": False},
    "fftshift": {"args": ['x'], "attrs": {'axes': 'None'}, "sharding": 'special', "custom_vjp": False},
    "ifftshift": {"args": ['x'], "attrs": {'axes': 'None'}, "sharding": 'special', "custom_vjp": False},
    "fftfreq": {"args": [], "attrs": {'n': '<required>', 'd': '1.0', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "rfftfreq": {"args": [], "attrs": {'n': '<required>', 'd': '1.0', 'dtype': 'None'}, "sharding": 'special', "custom_vjp": False},
    "slice": {"args": ['x'], "attrs": {'axes': '<required>', 'starts': '<required>', 'ends': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "strided_slice": {"args": ['x'], "attrs": {'axes': '<required>', 'starts': '<required>', 'ends': '<required>', 'strides': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "select_scatter": {"args": ['x', 'values'], "attrs": {'axis': '<required>', 'index': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "slice_scatter": {"args": ['x', 'value'], "attrs": {'axes': '<required>', 'starts': '<required>', 'ends': '<required>', 'strides': '<required>'}, "sharding": 'special', "custom_vjp": False},
    "unfold": {"args": ['x'], "attrs": {'axis': '<required>', 'size': '<required>', 'step': '<required>'}, "sharding": 'special', "custom_vjp": False},
}

# -- the schema's test specs (kind, input ranges or the input DSL, attrs, tolerances) --
OP_TESTS = {
    "add": {'args': ['x', 'y'], 'kind': 'binary'},
    "subtract": {'args': ['x', 'y'], 'kind': 'binary'},
    "multiply": {'args': ['x', 'y'], 'kind': 'binary'},
    "divide": {'args': ['x', 'y'], 'kind': 'binary', 'lo': 0.5, 'hi': 2.0},
    "floor_divide": {'args': ['x', 'y'], 'kind': 'binary', 'lo': 0.5, 'hi': 3.0, 'grad': False},
    "remainder": {'args': ['x', 'y'], 'kind': 'binary', 'lo': 0.5, 'hi': 2.0, 'grad': False},
    "pow": {'args': ['x', 'y'], 'kind': 'binary', 'lo': 0.5, 'hi': 2.0, 'grad_rtol': 0.03},
    "maximum": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "minimum": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "fmax": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "fmin": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "atan2": {'args': ['x', 'y'], 'kind': 'binary', 'lo': 0.3, 'hi': 2.0},
    "heaviside": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "gcd": {'args': ['x', 'y'], 'kind': 'skip'},
    "lcm": {'args': ['x', 'y'], 'kind': 'skip'},
    "hypot": {'args': ['x', 'y'], 'kind': 'binary', 'lo': 0.5, 'hi': 2.0},
    "logaddexp": {'args': ['x', 'y'], 'kind': 'binary'},
    "logaddexp2": {'args': ['x', 'y'], 'kind': 'binary'},
    "copysign": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "nextafter": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "ldexp": {'args': ['x', 'y'], 'kind': 'skip'},
    "inner": {'args': ['x', 'y'], 'kind': 'skip'},
    "outer": {'args': ['x', 'y'], 'kind': 'skip'},
    "kron": {'args': ['x', 'y'], 'kind': 'skip'},
    "lerp": {'args': ['x', 'y', 'weight'], 'kind': 'skip'},
    "exp": {'args': ['x'], 'kind': 'unary'},
    "expm1": {'args': ['x'], 'kind': 'unary'},
    "exp2": {'args': ['x'], 'kind': 'unary'},
    "log": {'args': ['x'], 'kind': 'unary', 'lo': 0.5, 'hi': 3.0},
    "log2": {'args': ['x'], 'kind': 'unary', 'lo': 0.5, 'hi': 3.0},
    "log10": {'args': ['x'], 'kind': 'unary', 'lo': 0.5, 'hi': 3.0},
    "log1p": {'args': ['x'], 'kind': 'unary', 'lo': -0.4, 'hi': 2.0},
    "sqrt": {'args': ['x'], 'kind': 'unary', 'lo': 0.3, 'hi': 3.0},
    "rsqrt": {'args': ['x'], 'kind': 'unary', 'lo': 0.3, 'hi': 3.0},
    "reciprocal": {'args': ['x'], 'kind': 'unary', 'lo': 0.4, 'hi': 2.0},
    "abs": {'args': ['x'], 'kind': 'unary', 'lo': 0.2, 'hi': 2.0},
    "square": {'args': ['x'], 'kind': 'unary'},
    "ceil": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "floor": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "round": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "trunc": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "frac": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "sign": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "sin": {'args': ['x'], 'kind': 'unary'},
    "cos": {'args': ['x'], 'kind': 'unary'},
    "tan": {'args': ['x'], 'kind': 'unary', 'lo': -1.0, 'hi': 1.0},
    "asin": {'args': ['x'], 'kind': 'unary', 'lo': -0.8, 'hi': 0.8, 'grad_rtol': 0.03},
    "acos": {'args': ['x'], 'kind': 'unary', 'lo': -0.8, 'hi': 0.8, 'grad_rtol': 0.03},
    "atan": {'args': ['x'], 'kind': 'unary'},
    "sinh": {'args': ['x'], 'kind': 'unary'},
    "cosh": {'args': ['x'], 'kind': 'unary'},
    "tanh": {'args': ['x'], 'kind': 'unary'},
    "asinh": {'args': ['x'], 'kind': 'unary'},
    "acosh": {'args': ['x'], 'kind': 'unary', 'lo': 1.3, 'hi': 3.0},
    "atanh": {'args': ['x'], 'kind': 'unary', 'lo': -0.7, 'hi': 0.7, 'grad_rtol': 0.03},
    "erf": {'args': ['x'], 'kind': 'unary'},
    "erfc": {'args': ['x'], 'kind': 'unary'},
    "erfinv": {'args': ['x'], 'kind': 'unary', 'lo': -0.7, 'hi': 0.7, 'grad_rtol': 0.03},
    "lgamma": {'args': ['x'], 'kind': 'unary', 'lo': 0.5, 'hi': 3.0},
    "digamma": {'args': ['x'], 'kind': 'unary', 'lo': 0.5, 'hi': 3.0, 'grad_rtol': 0.03},
    "polygamma": {'args': ['x'], 'kind': 'unary', 'lo': 0.5, 'hi': 3.0, 'attrs': {'n': 1}, 'grad': False},
    "i0": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "i0e": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "i1": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "i1e": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "neg": {'args': ['x'], 'kind': 'unary'},
    "deg2rad": {'args': ['x'], 'kind': 'unary'},
    "rad2deg": {'args': ['x'], 'kind': 'unary'},
    "angle": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "conj": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "real": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "imag": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "isnan": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "isinf": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "isfinite": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "sigmoid": {'args': ['x'], 'kind': 'unary'},
    "logit": {'args': ['x'], 'kind': 'unary', 'lo': 0.2, 'hi': 0.8, 'grad_rtol': 0.03},
    "stanh": {'args': ['x'], 'kind': 'unary', 'attrs': {'scale_a': 0.67, 'scale_b': 1.7159}},
    "nan_to_num": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "clip": {'args': ['x'], 'kind': 'unary', 'attrs': {'min': -0.5, 'max': 0.5}, 'grad': False},
    "scale": {'args': ['x'], 'kind': 'unary', 'attrs': {'scale': 2.0, 'bias': 0.5}},
    "increment": {'args': ['x'], 'kind': 'unary', 'attrs': {'value': 2.5}},
    "sum": {'args': ['x'], 'kind': 'reduction'},
    "mean": {'args': ['x'], 'kind': 'reduction'},
    "max": {'args': ['x'], 'kind': 'reduction', 'grad': False},
    "min": {'args': ['x'], 'kind': 'reduction', 'grad': False},
    "amax": {'args': ['x'], 'kind': 'reduction', 'grad': False},
    "amin": {'args': ['x'], 'kind': 'reduction', 'grad': False},
    "prod": {'args': ['x'], 'kind': 'reduction'},
    "logsumexp": {'args': ['x'], 'kind': 'reduction'},
    "count_nonzero": {'args': ['x'], 'kind': 'reduction', 'grad': False},
    "nansum": {'args': ['x'], 'kind': 'reduction'},
    "nanmean": {'args': ['x'], 'kind': 'reduction'},
    "all": {'args': ['x'], 'kind': 'skip'},
    "any": {'args': ['x'], 'kind': 'skip'},
    "cumsum": {'args': ['x'], 'kind': 'reduction', 'attrs': {'axis': 1}},
    "cumprod": {'args': ['x'], 'kind': 'reduction', 'attrs': {'dim': 1}, 'lo': 0.5, 'hi': 1.5},
    "logcumsumexp": {'args': ['x'], 'kind': 'reduction', 'attrs': {'axis': 1}},
    "trace": {'args': ['x'], 'kind': 'reduction', 'attrs': {}},
    "diagonal": {'args': ['x'], 'kind': 'reduction', 'attrs': {}, 'grad': False},
    "addmm": {'args': ['input', 'x', 'y'], 'kind': 'skip'},
    "diff": {'args': ['x'], 'kind': 'reduction', 'attrs': {'axis': 1}},
    "equal": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "not_equal": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "greater_than": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "greater_equal": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "less_than": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "less_equal": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "logical_and": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "logical_or": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "logical_xor": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "logical_not": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "isclose": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "allclose": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "equal_all": {'args': ['x', 'y'], 'kind': 'binary', 'grad': False},
    "bitwise_and": {'args': ['x', 'y'], 'kind': 'skip'},
    "bitwise_or": {'args': ['x', 'y'], 'kind': 'skip'},
    "bitwise_xor": {'args': ['x', 'y'], 'kind': 'skip'},
    "bitwise_not": {'args': ['x'], 'kind': 'skip'},
    "bitwise_left_shift": {'args': ['x', 'y'], 'kind': 'skip'},
    "bitwise_right_shift": {'args': ['x', 'y'], 'kind': 'skip'},
    "signbit": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "sinc": {'args': ['x'], 'kind': 'unary', 'grad_rtol': 0.03},
    "take": {'args': ['x', 'index'], 'kind': 'skip'},
    "isin": {'args': ['x', 'test_x'], 'kind': 'binary', 'grad': False},
    "vander": {'args': ['x'], 'kind': 'skip'},
    "trapezoid": {'args': ['y'], 'kind': 'reduction', 'attrs': {'axis': 1}},
    "cdist": {'args': ['x', 'y'], 'kind': 'skip'},
    "diag_embed": {'args': ['x'], 'kind': 'skip'},
    "fill_diagonal": {'args': ['x'], 'kind': 'skip'},
    "reshape": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'shape': [2, 6]}, 'grad': ['x']},
    "cast": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'dtype': 'float32'}, 'grad': ['x']},
    "flatten": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)'}, 'attrs': {'start_axis': 1, 'stop_axis': 2}, 'grad': ['x']},
    "transpose": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)'}, 'attrs': {'perm': [2, 0, 1]}, 'grad': ['x']},
    "moveaxis": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)'}, 'attrs': {'source': 0, 'destination': 2}, 'grad': ['x']},
    "swapaxes": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)'}, 'attrs': {'axis0': 0, 'axis1': 2}, 'grad': ['x']},
    "t": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'grad': ['x']},
    "matrix_transpose": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)'}, 'grad': ['x']},
    "squeeze": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 1, 4)'}, 'attrs': {'axis': 1}, 'grad': ['x']},
    "unsqueeze": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}, 'grad': ['x']},
    "concat": {'args': ['x'], 'kind': 'skip'},
    "stack": {'args': ['x'], 'kind': 'skip'},
    "unstack": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 0}},
    "split": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(6, 4)'}, 'attrs': {'num_or_sections': 3, 'axis': 0}},
    "chunk": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(6, 4)'}, 'attrs': {'chunks': 2}},
    "tensor_split": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(5, 4)'}, 'attrs': {'num_or_indices': 2}},
    "hsplit": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 6)'}, 'attrs': {'num_or_indices': 3}},
    "vsplit": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(6, 4)'}, 'attrs': {'num_or_indices': 3}},
    "dsplit": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)'}, 'attrs': {'num_or_indices': 2}},
    "tile": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3)'}, 'attrs': {'repeat_times': [2, 1]}, 'grad': ['x']},
    "expand": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(1, 3)'}, 'attrs': {'shape': [4, 3]}, 'grad': ['x']},
    "expand_as": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(1, 3)', 'y': 'rand(4, 3)'}, 'grad': ['x']},
    "broadcast_to": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(1, 3)'}, 'attrs': {'shape': [4, 3]}, 'grad': ['x']},
    "flip": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}, 'grad': ['x']},
    "rot90": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'k': 1}, 'grad': ['x']},
    "roll": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'shifts': 2, 'axis': 1}, 'grad': ['x']},
    "gather": {'args': ['x', 'index'], 'kind': 'expr', 'inputs': {'x': 'rand(5, 4)', 'index': 'randint(0, 5, (3,))'}, 'grad': ['x']},
    "gather_nd": {'args': ['x', 'index'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 5)', 'index': 'randint(0, 4, (3, 1))'}, 'grad': ['x']},
    "index_select": {'args': ['x', 'index'], 'kind': 'expr', 'inputs': {'x': 'rand(5, 4)', 'index': 'randint(0, 5, (3,))'}, 'grad': ['x']},
    "index_sample": {'args': ['x', 'index'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)', 'index': 'randint(0, 5, (3, 2))'}, 'grad': ['x']},
    "index_add": {'args': ['x', 'index', 'value'], 'kind': 'expr', 'inputs': {'x': 'rand(5, 3)', 'index': 'np.array([0, 2, 2])', 'value': 'rand(3, 3)'}, 'attrs': {'axis': 0}, 'grad': ['x', 'value']},
    "take_along_axis": {'args': ['arr', 'indices'], 'kind': 'expr', 'inputs': {'arr': 'rand(3, 5)', 'indices': 'randint(0, 5, (3, 2))'}, 'attrs': {'axis': 1, 'broadcast': False}, 'grad': ['arr']},
    "put_along_axis": {'args': ['arr', 'indices', 'values'], 'kind': 'expr', 'inputs': {'arr': 'rand(3, 5)', 'indices': 'randint(0, 5, (3, 2))', 'values': 'rand(3, 2)'}, 'attrs': {'axis': 1}, 'grad': ['arr', 'values']},
    "scatter": {'args': ['x', 'index', 'updates'], 'kind': 'expr', 'inputs': {'x': 'rand(5, 3)', 'index': 'np.array([0, 2])', 'updates': 'rand(2, 3)'}, 'grad': ['x', 'updates']},
    "scatter_nd": {'args': ['index', 'updates'], 'kind': 'expr', 'inputs': {'index': 'randint(0, 4, (3, 1))', 'updates': 'rand(3, 5)'}, 'attrs': {'shape': [4, 5]}, 'grad': ['updates']},
    "scatter_nd_add": {'args': ['x', 'index', 'updates'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 5)', 'index': 'randint(0, 4, (3, 1))', 'updates': 'rand(3, 5)'}, 'grad': ['x', 'updates']},
    "masked_fill": {'args': ['x', 'mask', 'value'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'mask': 'mask(3, 4)', 'value': 'np.float32(0.5)'}, 'grad': ['x']},
    "where": {'args': ['condition', 'x', 'y'], 'kind': 'expr', 'inputs': {'condition': 'mask(3, 4)', 'x': 'rand(3, 4)', 'y': 'rand(3, 4)'}, 'grad': ['x', 'y']},
    "repeat_interleave": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'repeats': 2, 'axis': 1}, 'grad': ['x']},
    "unbind": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 0}},
    "as_complex": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 2)'}},
    "as_real": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': '(rand(3, 4) + 1j * rand(3, 4)).astype(np.complex64)'}},
    "crop": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 5)'}, 'attrs': {'shape': [2, 3], 'offsets': [1, 1]}, 'grad': ['x']},
    "atleast_1d": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand()'}, 'grad': ['x']},
    "atleast_2d": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3)'}, 'grad': ['x']},
    "atleast_3d": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'grad': ['x']},
    "hstack": {'args': ['x'], 'kind': 'skip'},
    "vstack": {'args': ['x'], 'kind': 'skip'},
    "dstack": {'args': ['x'], 'kind': 'skip'},
    "column_stack": {'args': ['x'], 'kind': 'skip'},
    "row_stack": {'args': ['x'], 'kind': 'skip'},
    "numel": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}},
    "unflatten": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(6, 4)'}, 'attrs': {'axis': 0, 'shape': [2, 3]}, 'grad': ['x']},
    "diagonal_scatter": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 3)', 'y': 'rand(3)'}, 'grad': ['x', 'y']},
    "shard_index": {'args': ['input'], 'kind': 'expr', 'inputs': {'input': 'randint(0, 10, (6,))'}, 'attrs': {'index_num': 10, 'nshards': 2, 'shard_id': 0}},
    "argmax": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}},
    "argmin": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}},
    "argsort": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}},
    "sort": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}, 'grad': ['x']},
    "topk": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 6)'}, 'attrs': {'k': 2, 'axis': -1}, 'grad': ['x']},
    "kthvalue": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'k': 2}, 'grad': ['x']},
    "searchsorted": {'args': ['sorted_sequence', 'values'], 'kind': 'expr', 'inputs': {'sorted_sequence': 'sorted(8)', 'values': 'rand(5)'}},
    "bucketize": {'args': ['x', 'sorted_sequence'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'sorted_sequence': 'sorted(6)'}},
    "index_fill": {'args': ['x', 'index'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 3)', 'index': 'np.array([0, 2])'}, 'attrs': {'axis': 0, 'value': 0.0}, 'grad': ['x']},
    "var": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}, 'grad': ['x']},
    "std": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': 1}, 'grad': ['x'], 'grad_rtol': 0.03},
    "median": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'axis': 1}, 'grad': ['x']},
    "nanmedian": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'axis': 1}},
    "quantile": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'q': 0.5, 'axis': 1}, 'grad': ['x']},
    "nanquantile": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'q': 0.5, 'axis': 1}},
    "bincount": {'args': ['x'], 'kind': 'skip'},
    "corrcoef": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 8)'}},
    "histogram": {'args': ['input'], 'kind': 'expr', 'inputs': {'input': 'rand(20)'}, 'attrs': {'bins': 5}},
    "zeros": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'shape': [2, 3]}},
    "ones": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'shape': [2, 3]}},
    "full": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'shape': [2, 3], 'fill_value': 1.5}},
    "zeros_like": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3)'}},
    "ones_like": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3)'}},
    "full_like": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3)'}, 'attrs': {'fill_value': 0.25}},
    "empty": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'shape': [2, 3]}},
    "empty_like": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3)'}},
    "arange": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'start': 1, 'end': 7, 'step': 2}},
    "linspace": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'start': 0.0, 'stop': 1.0, 'num': 5}},
    "logspace": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'start': 0.0, 'stop': 2.0, 'num': 4}, 'rtol': 0.0001},
    "eye": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'num_rows': 4}},
    "diag": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4)'}, 'grad': ['x']},
    "diagflat": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 2)'}, 'grad': ['x']},
    "tril": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 4)'}, 'grad': ['x']},
    "triu": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 4)'}, 'grad': ['x']},
    "tril_indices": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'row': 4}},
    "triu_indices": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'row': 4}},
    "clone": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'grad': ['x']},
    "complex": {'args': ['real', 'imag'], 'kind': 'expr', 'inputs': {'real': 'rand(3, 4)', 'imag': 'rand(3, 4)'}},
    "polar": {'args': ['abs', 'angle'], 'kind': 'expr', 'inputs': {'abs': 'rand(3, lo=0.1, hi=1.0)', 'angle': 'rand(3)'}},
    "matmul": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)', 'y': 'rand(2, 4, 5)'}, 'grad': ['x', 'y'], 'rtol': 0.0001, 'atol': 1e-05},
    "mm": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'y': 'rand(4, 5)'}, 'grad': ['x', 'y'], 'rtol': 0.0001, 'atol': 1e-05},
    "bmm": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3, 4)', 'y': 'rand(2, 4, 5)'}, 'grad': ['x', 'y'], 'rtol': 0.0001, 'atol': 1e-05},
    "dot": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'y': 'rand(3, 4)'}, 'grad': ['x', 'y']},
    "mv": {'args': ['x', 'vec'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'vec': 'rand(4)'}, 'grad': ['x', 'vec']},
    "dist": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'y': 'rand(3, 4)'}, 'grad': ['x', 'y'], 'grad_rtol': 0.03},
    "cross": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 3)', 'y': 'rand(2, 3)'}, 'attrs': {'axis': 1}, 'grad': ['x', 'y']},
    "cholesky": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(4)'}, 'grad': ['x'], 'rtol': 0.0001, 'atol': 0.0001, 'grad_rtol': 0.03},
    "solve": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'posdef(4)', 'y': 'rand(4, 2)'}, 'grad': ['x', 'y'], 'rtol': 0.0001, 'atol': 0.0001, 'grad_rtol': 0.03},
    "triangular_solve": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'posdef(4)', 'y': 'rand(4, 2)'}, 'grad': ['y'], 'rtol': 0.0001, 'atol': 0.0001},
    "cholesky_solve": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 2)', 'y': 'np.linalg.cholesky(posdef(4))'}, 'grad': ['x'], 'rtol': 0.001, 'atol': 0.001},
    "inverse": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(4)'}, 'grad': ['x'], 'rtol': 0.001, 'atol': 0.001, 'grad_rtol': 0.03},
    "pinv": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 3)'}, 'rtol': 0.001, 'atol': 0.001},
    "det": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(3)'}, 'grad': ['x'], 'rtol': 0.001, 'atol': 0.001, 'grad_rtol': 0.05},
    "slogdet": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(3)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "matrix_power": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(3)'}, 'attrs': {'n': 2}, 'grad': ['x'], 'rtol': 0.001, 'atol': 0.001, 'grad_rtol': 0.03},
    "matrix_rank": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 3)'}},
    "qr": {'args': ['x'], 'kind': 'skip'},
    "svd": {'args': ['x'], 'kind': 'skip'},
    "svdvals": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 3)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "eigh": {'args': ['x'], 'kind': 'skip'},
    "eigvalsh": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(4)'}, 'rtol': 0.001, 'atol': 0.001},
    "multi_dot": {'args': ['tensors'], 'kind': 'skip'},
    "tensordot": {'args': ['x', 'y'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4, 5)', 'y': 'rand(4, 5, 2)'}, 'grad': ['x', 'y'], 'rtol': 0.0001, 'atol': 1e-05},
    "cond": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'posdef(4)'}, 'rtol': 0.001, 'atol': 0.001},
    "vector_norm": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'p': 2.0, 'axis': 1}, 'grad': ['x'], 'grad_rtol': 0.03},
    "matrix_norm": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'grad': ['x'], 'grad_rtol': 0.03},
    "householder_product": {'args': ['x', 'tau'], 'kind': 'skip'},
    "relu": {'args': ['x'], 'kind': 'unary'},
    "relu6": {'args': ['x'], 'kind': 'unary', 'lo': -8.0, 'hi': 8.0},
    "elu": {'args': ['x'], 'kind': 'unary'},
    "celu": {'args': ['x'], 'kind': 'unary'},
    "selu": {'args': ['x'], 'kind': 'unary'},
    "gelu": {'args': ['x'], 'kind': 'unary'},
    "silu": {'args': ['x'], 'kind': 'unary'},
    "swish": {'args': ['x'], 'kind': 'unary'},
    "mish": {'args': ['x'], 'kind': 'unary'},
    "softplus": {'args': ['x'], 'kind': 'unary'},
    "softsign": {'args': ['x'], 'kind': 'unary'},
    "softshrink": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "hardshrink": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "hardtanh": {'args': ['x'], 'kind': 'unary', 'lo': -2.0, 'hi': 2.0, 'grad': False},
    "hardsigmoid": {'args': ['x'], 'kind': 'unary', 'lo': -5.0, 'hi': 5.0, 'grad': False},
    "hardswish": {'args': ['x'], 'kind': 'unary', 'lo': -5.0, 'hi': 5.0, 'grad': False},
    "leaky_relu": {'args': ['x'], 'kind': 'unary'},
    "log_sigmoid": {'args': ['x'], 'kind': 'unary'},
    "tanhshrink": {'args': ['x'], 'kind': 'unary'},
    "thresholded_relu": {'args': ['x'], 'kind': 'unary', 'lo': -2.0, 'hi': 2.0, 'grad': False},
    "prelu": {'args': ['x', 'weight'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'weight': 'rand(4, lo=0.0, hi=0.5)'}, 'grad': ['x', 'weight']},
    "glu": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 8)'}, 'attrs': {'axis': -1}, 'grad': ['x']},
    "softmax": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': -1}, 'grad': ['x']},
    "log_softmax": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}, 'attrs': {'axis': -1}, 'grad': ['x']},
    "sgn": {'args': ['x'], 'kind': 'unary', 'grad': False},
    "frexp": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4, lo=0.1, hi=4.0)'}},
    "cummax": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'axis': 1}, 'grad': ['x'], 'out_index': 0},
    "cummin": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 5)'}, 'attrs': {'axis': 1}, 'grad': ['x'], 'out_index': 0},
    "isreal": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)'}},
    "fft": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(8)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "ifft": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(8)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "fft2": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 4)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "ifft2": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 4)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "fftn": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 4, 4)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "ifftn": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 4, 4)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "rfft": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(8)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "irfft": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': '(rand(5) + 1j * rand(5)).astype(np.complex64)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "rfft2": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 4)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "irfft2": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': '(rand(4, 3) + 1j * rand(4, 3)).astype(np.complex64)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "rfftn": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(2, 4, 4)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "irfftn": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': '(rand(2, 4, 3) + 1j * rand(2, 4, 3)).astype(np.complex64)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "hfft": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': '(rand(5) + 1j * rand(5)).astype(np.complex64)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "ihfft": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(8)'}, 'rtol': 0.0001, 'atol': 0.0001},
    "fftshift": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 6)'}, 'grad': ['x']},
    "ifftshift": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(4, 6)'}, 'grad': ['x']},
    "fftfreq": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'n': 8, 'd': 0.5}},
    "rfftfreq": {'args': [], 'kind': 'expr', 'inputs': {}, 'attrs': {'n': 8, 'd': 0.5}},
    "slice": {'args': ['x'], 'kind': 'skip'},
    "strided_slice": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(8, 4)'}, 'attrs': {'axes': [0], 'starts': [1], 'ends': [7], 'strides': [2]}, 'grad': ['x']},
    "select_scatter": {'args': ['x', 'values'], 'kind': 'expr', 'inputs': {'x': 'rand(3, 4)', 'values': 'rand(3)'}, 'attrs': {'axis': 1, 'index': 2}, 'grad': ['x', 'values']},
    "slice_scatter": {'args': ['x', 'value'], 'kind': 'expr', 'inputs': {'x': 'rand(6, 4)', 'value': 'rand(3, 4)'}, 'attrs': {'axes': [0], 'starts': [0], 'ends': [6], 'strides': [2]}, 'grad': ['x', 'value']},
    "unfold": {'args': ['x'], 'kind': 'expr', 'inputs': {'x': 'rand(8)'}, 'attrs': {'axis': 0, 'size': 3, 'step': 2}, 'grad': ['x']},
}

__all__ = ['add', 'subtract', 'multiply', 'divide', 'floor_divide', 'remainder', 'pow', 'maximum', 'minimum', 'fmax', 'fmin', 'atan2', 'heaviside', 'gcd', 'lcm', 'hypot', 'logaddexp', 'logaddexp2', 'copysign', 'nextafter', 'ldexp', 'inner', 'outer', 'kron', 'lerp', 'exp', 'expm1', 'exp2', 'log', 'log2', 'log10', 'log1p', 'sqrt', 'rsqrt', 'reciprocal', 'abs', 'square', 'ceil', 'floor', 'round', 'trunc', 'frac', 'sign', 'sin', 'cos', 'tan', 'asin', 'acos', 'atan', 'sinh', 'cosh', 'tanh', 'asinh', 'acosh', 'atanh', 'erf', 'erfc', 'erfinv', 'lgamma', 'digamma', 'polygamma', 'i0', 'i0e', 'i1', 'i1e', 'neg', 'deg2rad', 'rad2deg', 'angle', 'conj', 'real', 'imag', 'isnan', 'isinf', 'isfinite', 'sigmoid', 'logit', 'stanh', 'nan_to_num', 'clip', 'scale', 'increment', 'sum', 'mean', 'max', 'min', 'amax', 'amin', 'prod', 'logsumexp', 'count_nonzero', 'nansum', 'nanmean', 'all', 'any', 'cumsum', 'cumprod', 'logcumsumexp', 'trace', 'diagonal', 'addmm', 'diff', 'equal', 'not_equal', 'greater_than', 'greater_equal', 'less_than', 'less_equal', 'logical_and', 'logical_or', 'logical_xor', 'logical_not', 'isclose', 'allclose', 'equal_all', 'bitwise_and', 'bitwise_or', 'bitwise_xor', 'bitwise_not', 'bitwise_left_shift', 'bitwise_right_shift', 'signbit', 'sinc', 'take', 'isin', 'vander', 'trapezoid', 'cdist', 'diag_embed', 'fill_diagonal', 'reshape', 'cast', 'flatten', 'transpose', 'moveaxis', 'swapaxes', 't', 'matrix_transpose', 'squeeze', 'unsqueeze', 'concat', 'stack', 'unstack', 'split', 'chunk', 'tensor_split', 'hsplit', 'vsplit', 'dsplit', 'tile', 'expand', 'expand_as', 'broadcast_to', 'flip', 'rot90', 'roll', 'gather', 'gather_nd', 'index_select', 'index_sample', 'index_add', 'take_along_axis', 'put_along_axis', 'scatter', 'scatter_nd', 'scatter_nd_add', 'masked_fill', 'where', 'repeat_interleave', 'unbind', 'as_complex', 'as_real', 'crop', 'atleast_1d', 'atleast_2d', 'atleast_3d', 'hstack', 'vstack', 'dstack', 'column_stack', 'row_stack', 'numel', 'unflatten', 'diagonal_scatter', 'shard_index', 'argmax', 'argmin', 'argsort', 'sort', 'topk', 'kthvalue', 'searchsorted', 'bucketize', 'index_fill', 'var', 'std', 'median', 'nanmedian', 'quantile', 'nanquantile', 'bincount', 'corrcoef', 'histogram', 'zeros', 'ones', 'full', 'zeros_like', 'ones_like', 'full_like', 'empty', 'empty_like', 'arange', 'linspace', 'logspace', 'eye', 'diag', 'diagflat', 'tril', 'triu', 'tril_indices', 'triu_indices', 'clone', 'complex', 'polar', 'matmul', 'mm', 'bmm', 'dot', 'mv', 'dist', 'cross', 'cholesky', 'solve', 'triangular_solve', 'cholesky_solve', 'inverse', 'pinv', 'det', 'slogdet', 'matrix_power', 'matrix_rank', 'qr', 'svd', 'svdvals', 'eigh', 'eigvalsh', 'multi_dot', 'tensordot', 'cond', 'vector_norm', 'matrix_norm', 'householder_product', 'relu', 'relu6', 'elu', 'celu', 'selu', 'gelu', 'silu', 'swish', 'mish', 'softplus', 'softsign', 'softshrink', 'hardshrink', 'hardtanh', 'hardsigmoid', 'hardswish', 'leaky_relu', 'log_sigmoid', 'tanhshrink', 'thresholded_relu', 'prelu', 'glu', 'softmax', 'log_softmax', 'sgn', 'frexp', 'cummax', 'cummin', 'isreal', 'fft', 'ifft', 'fft2', 'ifft2', 'fftn', 'ifftn', 'rfft', 'irfft', 'rfft2', 'irfft2', 'rfftn', 'irfftn', 'hfft', 'ihfft', 'fftshift', 'ifftshift', 'fftfreq', 'rfftfreq', 'slice', 'strided_slice', 'select_scatter', 'slice_scatter', 'unfold'] + ['OP_INFO', 'OP_TESTS']
