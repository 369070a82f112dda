"""Convolution, pooling and the conv-side common functionals and layers
of the port against the JAX package's on the CPU: the same seeded numpy
inputs and copied weights through both.  fp32; convolutions sum in
another order than XLA's, so 1e-5 relative with 1e-5 absolute; exact
where nothing is summed (max pooling, shuffles, pads, indices).  Cases
where the JAX package ignores an argument (``ceil_mode``, ``output_size``,
masks outside ``max_pool2d``) are held against torch's own functions or
an independent numpy reference instead."""

import numpy as np
import pytest
import torch
import torch.nn.functional as TTF

import paddle_tpu as pp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = 1e-5


def _r(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _both(fn_name, arrays, **kw):
    j = getattr(JF, fn_name)(*[pp.to_tensor(a) if a is not None else None
                               for a in arrays], **kw)
    t = getattr(TF, fn_name)(*[torch.from_numpy(a) if a is not None else None
                               for a in arrays], **kw)
    return j, t


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else x.numpy()


def _close(t, j, rtol=TOL, atol=TOL):
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(_np(t), _np(j), rtol=rtol, atol=atol)


# -- convolutions -------------------------------------------------------------

CONV = [
    # (n, x shape, w shape, kwargs)
    (1, (2, 4, 19), (6, 4, 3), dict(stride=2, padding=1)),
    (1, (2, 4, 19), (6, 2, 5), dict(groups=2, dilation=2, padding="SAME")),
    (2, (2, 3, 9, 11), (5, 3, 3, 3), dict(stride=2, padding=1)),
    (2, (2, 3, 9, 11), (5, 3, 3, 2), dict(padding=[1, 2, 0, 1])),
    (2, (2, 4, 9, 11), (8, 2, 3, 3), dict(groups=2, dilation=(2, 1),
                                          padding="VALID")),
    (2, (2, 3, 10, 7), (4, 3, 4, 3), dict(stride=(2, 3), padding="SAME")),
    (2, (2, 9, 11, 3), (5, 3, 3, 3), dict(padding=1,
                                          data_format="NHWC")),
    (2, (1, 6, 8, 8), (6, 1, 3, 3), dict(groups=6, padding=[(1, 1),
                                                            (2, 0)])),
    (3, (1, 2, 5, 6, 7), (3, 2, 3, 2, 3), dict(stride=2, padding=1)),
    (3, (1, 5, 6, 7, 2), (3, 2, 3, 3, 3), dict(padding="SAME",
                                               data_format="NDHWC")),
]


@pytest.mark.parametrize("n,xs,ws,kw", CONV,
                         ids=[f"conv{c[0]}d-{i}" for i, c in enumerate(CONV)])
def test_conv_matches_jax(n, xs, ws, kw):
    x, w, b = _r(xs, 1), _r(ws, 2, 0.3), _r((ws[0],), 3)
    j, t = _both(f"conv{n}d", [x, w, b], **kw)
    _close(t, j)


CONV_T = [
    (1, (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1)),
    (1, (2, 4, 7), (4, 2, 4), dict(stride=3, output_padding=2, groups=2)),
    (2, (1, 4, 5, 5), (4, 6, 3, 3), dict(stride=2, padding=1)),
    (2, (1, 4, 5, 6), (4, 3, 3, 3), dict(stride=2, padding=[1, 0, 2, 1],
                                         output_padding=1)),
    (2, (2, 4, 5, 5), (4, 2, 3, 3), dict(groups=2, dilation=2, stride=2)),
    (2, (1, 5, 5, 4), (4, 3, 3, 3), dict(stride=2, padding=1,
                                         data_format="NHWC")),
    (3, (1, 2, 3, 4, 3), (2, 3, 3, 3, 3), dict(stride=2, padding=1,
                                               output_padding=1)),
]


@pytest.mark.parametrize("n,xs,ws,kw", CONV_T,
                         ids=[f"conv{c[0]}d_t-{i}" for i, c in
                              enumerate(CONV_T)])
def test_conv_transpose_matches_jax(n, xs, ws, kw):
    x, w, b = _r(xs, 4), _r(ws, 5, 0.3), _r((ws[1] * kw.get("groups", 1),), 6)
    j, t = _both(f"conv{n}d_transpose", [x, w, b], **kw)
    _close(t, j)


def test_conv_transpose_output_size_and_torch():
    """``output_size`` is the output padding that reaches it (the JAX
    package ignores it): equal to the call with that output padding and
    to torch's ConvTranspose2d."""
    x, w = _r((1, 4, 5, 5), 7), _r((4, 6, 3, 3), 8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = TF.conv2d_transpose(tx, tw, stride=2, padding=1,
                              output_size=[10, 10])
    assert got.shape == (1, 6, 10, 10)
    want = TF.conv2d_transpose(tx, tw, stride=2, padding=1,
                               output_padding=1)
    torch.testing.assert_close(got, want)
    ref = TTF.conv_transpose2d(tx, tw, stride=2, padding=1,
                               output_padding=1)
    torch.testing.assert_close(got, ref)


def test_conv_transpose_rejects_string_padding():
    with pytest.raises(ValueError):
        TF.conv2d_transpose(torch.ones(1, 2, 3, 3), torch.ones(2, 2, 3, 3),
                            padding="SAME")


@pytest.mark.parametrize("cls,args,kw,xs", [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 11)),
    ("Conv2D", (3, 8, 3), dict(padding=1, groups=1), (2, 3, 8, 8)),
    ("Conv2D", (4, 8, (3, 1)), dict(groups=2, bias_attr=False), (1, 4, 6, 6)),
    ("Conv3D", (2, 4, 3), dict(padding="SAME"), (1, 2, 4, 5, 6)),
    ("Conv1DTranspose", (4, 2, 3), dict(stride=2), (2, 4, 5)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1,
                                        output_padding=1), (1, 4, 5, 5)),
    ("Conv3DTranspose", (2, 2, 3), dict(stride=2), (1, 2, 3, 3, 3)),
])
def test_conv_layers_state_dict_and_forward(cls, args, kw, xs):
    """Names, shapes and the default initializers' bounds of each conv
    layer; the JAX layer's weights loaded as numpy give its output."""
    pp.seed(0)
    jl = getattr(jnn, cls)(*args, **kw)
    tl = getattr(tnn, cls)(*args, **kw)
    js = {k: v.numpy() for k, v in jl.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: v.shape for k, v in js.items()}
    # Kaiming-uniform bound gain * sqrt(3 / fan_in), gain sqrt(2/(1+5))
    fan_in = args[0] * np.prod(jl.weight.shape[2:]) // kw.get("groups", 1)
    bound = np.sqrt(2.0 / 6.0) * np.sqrt(3.0 / fan_in)
    assert float(tl.weight.abs().max()) <= bound + 1e-6
    tl.set_state_dict(js)
    x = _r(xs, 9)
    _close(tl(torch.from_numpy(x)), jl(pp.to_tensor(x)))


# -- pooling ------------------------------------------------------------------

POOL = [
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 10), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 10), dict(kernel_size=(2, 3), stride=(1, 2))),
    ("max_pool2d", (2, 3, 9, 10), dict(kernel_size=3, stride=2,
                                       padding="SAME")),
    ("max_pool2d", (2, 3, 9, 10), dict(kernel_size=3, padding=[0, 2, 1, 0])),
    ("max_pool2d", (2, 9, 10, 3), dict(kernel_size=2, data_format="NHWC")),
    ("max_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=2, stride=2)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                    exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 10), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 9, 10), dict(kernel_size=3, stride=2, padding=1,
                                       exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 10), dict(kernel_size=3, padding=[1, 2, 0, 1])),
    ("avg_pool2d", (2, 3, 9, 10), dict(kernel_size=3, stride=2,
                                       padding="SAME")),
    ("avg_pool2d", (2, 9, 10, 3), dict(kernel_size=2, data_format="NHWC")),
    ("avg_pool3d", (1, 2, 5, 6, 7), dict(kernel_size=3, stride=2,
                                         padding=1)),
    ("adaptive_avg_pool1d", (2, 3, 11), dict(output_size=4)),
    ("adaptive_avg_pool2d", (2, 3, 9, 10), dict(output_size=(4, 3))),
    ("adaptive_avg_pool2d", (2, 3, 8, 8), dict(output_size=1)),
    ("adaptive_avg_pool2d", (2, 9, 10, 3), dict(output_size=4,
                                                data_format="NHWC")),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), dict(output_size=(2, 3, 4))),
    ("adaptive_max_pool1d", (2, 3, 11), dict(output_size=4)),
    ("adaptive_max_pool2d", (2, 3, 9, 10), dict(output_size=(4, 3))),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 7), dict(output_size=(2, 3, 4))),
]


@pytest.mark.parametrize("fn,xs,kw", POOL,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(POOL)])
def test_pool_matches_jax(fn, xs, kw):
    x = _r(xs, 10)
    j, t = _both(fn, [x], **kw)
    _close(t, j, rtol=TOL, atol=1e-6)


def test_max_pool2d_mask_matches_jax_and_unpools():
    """JAX's convention: int32 indices into each channel's flattened
    H*W plane; max_unpool2d puts each maximum back there."""
    x = _r((2, 3, 8, 9), 11)
    (jo, jm), (to, tm) = [_both("max_pool2d", [x], kernel_size=3, stride=2,
                                padding=1, return_mask=True)[i]
                          for i in (0, 1)]
    _close(to, jo, atol=0)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.numpy()))
    ju = JF.max_unpool2d(jo, jm, 3, stride=2, padding=1,
                         output_size=[8, 9])
    tu = TF.max_unpool2d(to, tm, 3, stride=2, padding=1, output_size=[8, 9])
    _close(tu, ju, atol=0)
    ju = JF.max_unpool2d(jo, jm, 2)   # the default output size
    tu = TF.max_unpool2d(to, tm, 2)
    _close(tu, ju, atol=0)


def _np_max_pool(x, k, s, pads, ceil):
    """numpy reference: (values, flat indices) of a 2-d max pool."""
    n, c, h, w = x.shape
    (t, b), (l, r) = pads

    def out(L, lo, hi, kk, ss):
        span = L + lo + hi - kk
        o = (-(-span // ss) if ceil else span // ss) + 1
        if ceil and (o - 1) * ss >= L + lo:
            o -= 1
        return o
    oh, ow = out(h, t, b, k, s), out(w, l, r, k, s)
    vals = np.full((n, c, oh, ow), -np.inf, np.float32)
    idx = np.zeros((n, c, oh, ow), np.int64)
    for i in range(oh):
        for j in range(ow):
            for di in range(k):
                for dj in range(k):
                    y, z = i * s + di - t, j * s + dj - l
                    if 0 <= y < h and 0 <= z < w:
                        v = x[:, :, y, z]
                        better = v > vals[:, :, i, j]
                        vals[:, :, i, j] = np.where(better, v,
                                                    vals[:, :, i, j])
                        idx[:, :, i, j] = np.where(better, y * w + z,
                                                   idx[:, :, i, j])
    return vals, idx


@pytest.mark.parametrize("pads,ceil", [(((1, 1), (1, 1)), True),
                                       (((0, 2), (1, 0)), False),
                                       (((0, 1), (2, 1)), True)])
def test_max_pool_ceil_and_uneven_mask_vs_numpy(pads, ceil):
    """``ceil_mode`` and unequal sides (the JAX package ignores the one
    and refuses masks with either): values and indices against numpy."""
    x = _r((2, 2, 7, 8), 12)
    padding = [pads[0][0], pads[0][1], pads[1][0], pads[1][1]]
    out, mask = TF.max_pool2d(torch.from_numpy(x), 3, stride=2,
                              padding=padding, ceil_mode=ceil,
                              return_mask=True)
    vals, idx = _np_max_pool(x, 3, 2, pads, ceil)
    np.testing.assert_array_equal(out.numpy(), vals)
    np.testing.assert_array_equal(mask.numpy(), idx)


def test_avg_pool_ceil_mode_and_divisor_vs_torch():
    x = torch.from_numpy(_r((2, 3, 9, 10), 13))
    for exclusive in (True, False):
        got = TF.avg_pool2d(x, 3, stride=2, padding=1, ceil_mode=True,
                            exclusive=exclusive)
        torch.testing.assert_close(got, TTF.avg_pool2d(
            x, 3, 2, 1, ceil_mode=True, count_include_pad=not exclusive))
    got = TF.avg_pool2d(x, 2, divisor_override=3)
    torch.testing.assert_close(got, TTF.avg_pool2d(x, 2,
                                                   divisor_override=3))
    # unequal sides with ceil: the tail past the padding counts nothing
    got = TF.avg_pool1d(torch.ones(1, 1, 6), 3, stride=2,
                        padding=[0, 1], ceil_mode=True, exclusive=False)
    np.testing.assert_allclose(got.numpy()[0, 0], [1.0, 1.0, 2 / 3])


def test_masks_of_1d_3d_and_adaptive():
    x = torch.from_numpy(_r((2, 3, 6, 7, 5), 14))
    out, mask = TF.max_pool3d(x, 2, return_mask=True)
    ref, ridx = TTF.max_pool3d(x, 2, return_indices=True)
    torch.testing.assert_close(out, ref)
    assert torch.equal(mask, ridx.to(torch.int32))
    out, mask = TF.adaptive_max_pool2d(x[:, :, 0], 3, return_mask=True)
    ref, ridx = TTF.adaptive_max_pool2d(x[:, :, 0], 3, return_indices=True)
    assert torch.equal(mask, ridx.to(torch.int32))
    out, mask = TF.max_pool1d(x[:, :, 0, 0], 2, return_mask=True)
    assert mask.shape == out.shape == (2, 3, 2)


@pytest.mark.parametrize("cls,args,kw,xs", [
    ("MaxPool2D", (3, 2, 1), {}, (2, 3, 9, 9)),
    ("AvgPool2D", (3, 2, 1), {}, (2, 3, 9, 9)),
    ("MaxPool1D", (2,), {}, (2, 3, 9)),
    ("AvgPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    ("AdaptiveAvgPool2D", (1,), {}, (2, 3, 7, 7)),
    ("AdaptiveMaxPool1D", (3,), {}, (2, 3, 10)),
])
def test_pool_layers_match_jax(cls, args, kw, xs):
    x = _r(xs, 15)
    _close(getattr(tnn, cls)(*args, **kw)(torch.from_numpy(x)),
           getattr(jnn, cls)(*args, **kw)(pp.to_tensor(x)), atol=1e-6)


def test_pool_layer_passes_return_mask():
    out, mask = tnn.MaxPool2D(2, return_mask=True)(torch.ones(1, 1, 4, 4))
    assert mask.dtype == torch.int32 and out.shape == (1, 1, 2, 2)


# -- the conv-side common functionals -----------------------------------------

COMMON = [
    ("one_hot", lambda: [np.array([[0, 3], [2, 5]], np.int32)],
     dict(num_classes=4)),
    ("label_smooth", lambda: [np.eye(5, dtype=np.float32)[[1, 3, 0]]],
     dict(epsilon=0.2)),
    ("normalize", lambda: [_r((3, 5, 4), 16)], dict(p=2, axis=1)),
    ("normalize", lambda: [_r((3, 5), 16)], dict(p=1, axis=-1)),
    ("pixel_shuffle", lambda: [_r((2, 8, 3, 4), 17)],
     dict(upscale_factor=2)),
    ("pixel_shuffle", lambda: [_r((2, 3, 4, 8), 17)],
     dict(upscale_factor=2, data_format="NHWC")),
    ("pixel_unshuffle", lambda: [_r((2, 2, 6, 4), 18)],
     dict(downscale_factor=2)),
    ("channel_shuffle", lambda: [_r((2, 6, 3, 3), 19)], dict(groups=3)),
    ("channel_shuffle", lambda: [_r((2, 3, 3, 6), 19)],
     dict(groups=2, data_format="NHWC")),
    ("unfold", lambda: [_r((2, 3, 7, 8), 20)],
     dict(kernel_sizes=3, strides=2, paddings=1, dilations=1)),
    ("unfold", lambda: [_r((1, 2, 6, 6), 20)],
     dict(kernel_sizes=[2, 3], strides=1, paddings=0, dilations=2)),
    ("fold", lambda: [_r((2, 3 * 9, 16), 21)],
     dict(output_sizes=[8, 8], kernel_sizes=3, strides=2, paddings=1)),
    ("interpolate", lambda: [_r((2, 3, 4, 5), 22)],
     dict(scale_factor=2, mode="nearest")),
    ("interpolate", lambda: [_r((2, 3, 4, 5), 22)],
     dict(size=[8, 15], mode="bilinear")),
    ("interpolate", lambda: [_r((2, 4, 5, 3), 22)],
     dict(scale_factor=2, mode="bilinear", data_format="NHWC")),
    ("interpolate", lambda: [_r((2, 3, 6), 22)],
     dict(scale_factor=3, mode="linear")),
    ("upsample", lambda: [_r((1, 2, 3, 3), 23)], dict(scale_factor=2)),
    ("affine_grid", lambda: [_r((2, 2, 3), 24)],
     dict(out_shape=[2, 3, 5, 6], align_corners=True)),
    ("affine_grid", lambda: [_r((2, 2, 3), 24)],
     dict(out_shape=[2, 3, 5, 6], align_corners=False)),
    ("grid_sample", lambda: [_r((2, 3, 6, 7), 25),
                             np.clip(_r((2, 4, 5, 2), 26, 0.7), -1.2, 1.2)],
     dict(mode="bilinear", padding_mode="zeros")),
    ("grid_sample", lambda: [_r((2, 3, 6, 7), 25),
                             np.clip(_r((2, 4, 5, 2), 26, 0.7), -1.2, 1.2)],
     dict(mode="bilinear", padding_mode="border", align_corners=False)),
    ("grid_sample", lambda: [_r((2, 3, 6, 7), 25),
                             np.clip(_r((2, 4, 5, 2), 27, 0.5), -1, 1)],
     dict(mode="nearest")),
    ("zeropad2d", lambda: [_r((2, 3, 4, 5), 28)], dict(padding=[1, 2, 0, 3])),
    ("zeropad2d", lambda: [_r((2, 4, 5, 3), 28)],
     dict(padding=1, data_format="NHWC")),
    ("temporal_shift", lambda: [_r((6, 8, 3, 3), 29)],
     dict(seg_num=3, shift_ratio=0.25)),
    ("pad", lambda: [_r((2, 3, 4, 5), 30)],
     dict(pad=[1, 2, 3, 0], mode="reflect")),
]


@pytest.mark.parametrize("fn,make,kw", COMMON,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(COMMON)])
def test_common_functional_matches_jax(fn, make, kw):
    arrays = make()
    j, t = _both(fn, arrays, **kw)
    _close(t, j, rtol=TOL, atol=TOL)


def test_interpolate_align_corners_and_bicubic_vs_torch():
    """The reference's modes (the JAX package's resize ignores
    ``align_corners`` and antialiases a downsample): torch's own."""
    x = torch.from_numpy(_r((1, 2, 5, 6), 31))
    for mode, ac in (("bilinear", True), ("bicubic", False),
                     ("bicubic", True)):
        got = TF.interpolate(x, size=[7, 4], mode=mode, align_corners=ac)
        torch.testing.assert_close(got, TTF.interpolate(
            x, size=[7, 4], mode=mode, align_corners=ac))
    got = TF.interpolate(x, size=[3, 3], mode="area")
    torch.testing.assert_close(got, TTF.adaptive_avg_pool2d(x, [3, 3]))


LAYERS = [
    ("Upsample", dict(scale_factor=2), (1, 2, 3, 4)),
    ("UpsamplingNearest2D", dict(scale_factor=2), (1, 2, 3, 4)),
    ("Pad1D", dict(padding=[1, 2]), (2, 3, 5)),
    ("Pad2D", dict(padding=[1, 0, 2, 1], mode="replicate"), (2, 3, 4, 5)),
    ("Pad3D", dict(padding=1, value=0.5), (1, 2, 3, 3, 3)),
    ("ZeroPad2D", dict(padding=[1, 1, 2, 0]), (2, 3, 4, 5)),
    ("PixelShuffle", dict(upscale_factor=2), (1, 8, 3, 3)),
    ("PixelUnshuffle", dict(downscale_factor=2), (1, 2, 4, 6)),
    ("ChannelShuffle", dict(groups=2), (1, 4, 3, 3)),
    ("Unfold", dict(kernel_sizes=2, strides=2), (1, 3, 4, 6)),
    ("Fold", dict(output_sizes=[4, 6], kernel_sizes=2, strides=2),
     (1, 12, 6)),
]


@pytest.mark.parametrize("cls,kw,xs", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_common_layers_match_jax(cls, kw, xs):
    x = _r(xs, 32)
    _close(getattr(tnn, cls)(**kw)(torch.from_numpy(x)),
           getattr(jnn, cls)(**kw)(pp.to_tensor(x)))


def test_conv_grads_match_jax():
    """A conv2d -> max_pool2d -> avg_pool2d chain's gradients with
    respect to the input and the weight."""
    x, w = _r((2, 3, 8, 8), 33), _r((4, 3, 3, 3), 34, 0.3)
    jx = pp.to_tensor(x, stop_gradient=False)
    jw = pp.to_tensor(w, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    jy = JF.avg_pool2d(JF.max_pool2d(JF.conv2d(jx, jw, padding=1), 2), 2)
    ty = TF.avg_pool2d(TF.max_pool2d(TF.conv2d(tx, tw, padding=1), 2), 2)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    _close(tx.grad, jx.grad)
    _close(tw.grad, jw.grad)
