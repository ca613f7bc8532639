"""The port's padding, shuffle and adaptive-pool layers against heat_tpu's, on the CPU.

Each case runs ``test_torch_nn_layers.check_layer`` (the same seeded
inputs forward, one seeded cotangent backward through ``jax.vjp`` and
torch's autograd).  Tolerance, float32: rtol 1e-5, atol 1e-5 (the pads
and shuffles move values exactly; the pools' means round once).  The
crops (negative widths), the reflection and circular pads wider than
their axis, and a pool that keeps an extent (``None``) are the cases
where the two libraries' conventions could part.
"""

import numpy as np
import pytest
import torch

import heat_tpu_torch as ht
from test_torch_nn_layers import _f, check_layer

X = _f(3, 4, 5)
XL = _f(3, 4, 10, seed=4)
X2 = _f(2, 3, 4, 5, seed=1)
X3 = _f(2, 4, 3, 4, 5, seed=2)


def _same(name, *args, inputs, **kw):
    return (lambda r: getattr(r, name)(*args, **kw), lambda p: getattr(p, name)(*args, **kw), inputs, {})


CASES = {
    "ZeroPad1d": _same("ZeroPad1d", 2, inputs=[X]),
    "ZeroPad2d": _same("ZeroPad2d", (1, 2, 0, 3), inputs=[X2]),
    "ZeroPad3d": _same("ZeroPad3d", 1, inputs=[X3]),
    "ConstantPad1d_crop": _same("ConstantPad1d", (2, -1), 0.5, inputs=[X]),
    "ConstantPad2d": _same("ConstantPad2d", 1, -1.0, inputs=[X2]),
    "ConstantPad3d": _same("ConstantPad3d", (1, 0, 0, 1, 2, 0), 2.0, inputs=[X3]),
    "ReflectionPad1d": _same("ReflectionPad1d", (2, 3), inputs=[X]),
    "ReflectionPad1d_wide": _same("ReflectionPad1d", (7, 6), inputs=[X]),
    "ReflectionPad2d": _same("ReflectionPad2d", (1, 2, 2, 1), inputs=[X2]),
    "ReflectionPad3d": _same("ReflectionPad3d", 1, inputs=[X3]),
    "ReplicationPad1d": _same("ReplicationPad1d", 3, inputs=[X]),
    "ReplicationPad2d_crop": _same("ReplicationPad2d", (1, -1, 2, 0), inputs=[X2]),
    "ReplicationPad3d": _same("ReplicationPad3d", (1, 2, 0, 1, 1, 0), inputs=[X3]),
    "CircularPad1d": _same("CircularPad1d", (2, 1), inputs=[X]),
    "CircularPad1d_wide": _same("CircularPad1d", 12, inputs=[X]),
    "CircularPad2d": _same("CircularPad2d", (1, 1, 2, 0), inputs=[X2]),
    "CircularPad3d": _same("CircularPad3d", 1, inputs=[X3]),
    "PixelShuffle": _same("PixelShuffle", 2, inputs=[_f(2, 8, 3, 4)]),
    "PixelUnshuffle": _same("PixelUnshuffle", 2, inputs=[_f(2, 2, 4, 6)]),
    "ChannelShuffle": _same("ChannelShuffle", 3, inputs=[_f(2, 6, 3, 2)]),
    "AdaptiveMaxPool1d": _same("AdaptiveMaxPool1d", 5, inputs=[XL]),
    "AdaptiveMaxPool2d_keep": _same("AdaptiveMaxPool2d", (2, None), inputs=[X2]),
    "AdaptiveMaxPool3d": _same("AdaptiveMaxPool3d", 1, inputs=[X3]),
    "AdaptiveAvgPool3d": _same("AdaptiveAvgPool3d", (3, 2, 5), inputs=[X3]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_reference(name):
    check_layer(name, CASES[name])


def test_wide_pads_follow_numpy():
    """A circular or reflection pad wider than its axis wraps or reflects
    again, as the reference's ``jnp.pad`` (numpy's rule) does."""
    x = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    for cls, mode in ((ht.nn.CircularPad1d, "wrap"), (ht.nn.ReflectionPad1d, "reflect"),
                      (ht.nn.ReplicationPad1d, "edge")):
        got = cls((9, 11))(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (0, 0), (9, 11)), mode=mode))
    with pytest.raises(ValueError, match="at least 3-D"):
        ht.nn.CircularPad2d(1)(torch.zeros(4, 4))
