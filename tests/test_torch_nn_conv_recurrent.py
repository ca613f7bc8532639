"""The port's spatial, extended and recurrent layers against heat_tpu's, on the CPU.

Each case runs ``test_torch_nn_layers.check_layer``: the reference's
parameters carried by ``convert.load_reference``, the same seeded numpy
inputs forward, and one seeded cotangent backward through ``jax.vjp``
and torch's autograd, for every parameter and float input.  Tolerance,
float32: rtol 1e-5, atol 1e-5 (convolutions of at most 36 products, a
recurrence of 4 steps).  The strided and padded convolutions, the
transposed ones at ``output_padding`` >= 1 and the non-integer
upsampling ratios are the cases where the two libraries' conventions
could part; the MaxPool cases hold the indices MaxUnpool takes.  The layers that draw random
numbers in training (the alpha dropouts) are held in evaluation here and
by their statistics in training.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ref_ht

import heat_tpu_torch as ht
from test_torch_nn_layers import _f, _ints, check_layer

CPU = {"device": "cpu"}
X = _f(3, 4, 5)
XL = _f(3, 4, 10, seed=4)
X2 = _f(2, 3, 4, 5, seed=1)
X3 = _f(2, 4, 3, 4, 5, seed=2)
POS2 = np.abs(X2) + 0.1
POS3 = np.abs(X3) + 0.1
SEQ = _f(3, 4, 5, seed=6)  # (B, S, F)
H0 = _f(2, 3, 6, seed=7)
C0 = _f(2, 3, 6, seed=8)


def _pooled(rank, kernel, x):
    """torch's max pool of x with its indices (the reference's are the same: the MaxPool cases)."""
    v, i = getattr(torch.nn.functional, f"max_pool{rank}d")(torch.from_numpy(x), kernel, return_indices=True)
    return v.numpy(), i.numpy()


V1, I1 = _pooled(1, 2, XL)
V2, I2 = _pooled(2, 2, X2[..., :4])
V3, I3 = _pooled(3, (1, 2, 2), X3[..., :4])
FIXED_INDEX = {"fixed": (1,)}


def _same(name, *args, inputs, opts=None, cpu=False, **kw):
    """A case whose two constructors take the same arguments (the port's also ``device='cpu'`` where ``cpu``)."""
    return (lambda r: getattr(r, name)(*args, **kw), lambda p: getattr(p, name)(*args, **kw, **(CPU if cpu else {})),
            inputs, dict(opts or {}))


CASES = {
    # nn/spatial.py
    "Conv1d": _same("Conv1d", 4, 6, 3, inputs=[XL], cpu=True),
    "Conv1d_stride_padding": _same("Conv1d", 4, 6, 3, stride=2, padding=1, inputs=[XL], cpu=True),
    "Conv1d_nobias": _same("Conv1d", 4, 2, 1, bias=False, inputs=[X], cpu=True),
    "Conv3d": _same("Conv3d", 4, 5, 2, inputs=[X3], cpu=True),
    "Conv3d_stride_padding": _same("Conv3d", 4, 5, (2, 3, 1), stride=(1, 2, 1), padding=(1, 0, 1), inputs=[X3],
                                   cpu=True),
    "MaxPool1d": _same("MaxPool1d", 2, inputs=[XL]),
    "MaxPool1d_indices": _same("MaxPool1d", 3, 2, return_indices=True, inputs=[XL]),
    "MaxPool3d_indices": _same("MaxPool3d", 2, return_indices=True, inputs=[_f(2, 3, 4, 4, 6, seed=9)]),
    "AvgPool1d": _same("AvgPool1d", 3, 2, inputs=[XL]),
    "AvgPool3d": _same("AvgPool3d", (1, 2, 2), inputs=[X3]),
    "AdaptiveAvgPool1d": _same("AdaptiveAvgPool1d", 5, inputs=[XL]),
    "CosineSimilarity": _same("CosineSimilarity", inputs=[_f(6, 8), _f(6, 8, seed=1)]),
    "CosineSimilarity_last": _same("CosineSimilarity", dim=-1, eps=1e-3, inputs=[X, _f(3, 4, 5, seed=1)]),
    "PairwiseDistance": _same("PairwiseDistance", inputs=[_f(6, 8), _f(6, 8, seed=1)]),
    "PairwiseDistance_p1_keepdim": _same("PairwiseDistance", p=1.0, keepdim=True,
                                         inputs=[_f(6, 8), _f(6, 8, seed=1)]),
    "Bilinear": _same("Bilinear", 4, 3, 5, inputs=[_f(6, 4), _f(6, 3, seed=1)], cpu=True),
    "LocalResponseNorm": _same("LocalResponseNorm", 3, inputs=[X2]),
    "LocalResponseNorm_even": _same("LocalResponseNorm", 4, alpha=1e-2, beta=0.5, k=2.0, inputs=[X]),
    "Upsample_nearest": _same("Upsample", scale_factor=2, inputs=[X2]),
    "Upsample_nearest_ratio": _same("Upsample", size=(7, 9), inputs=[X2]),
    "Upsample_bilinear": _same("Upsample", scale_factor=2, mode="bilinear", inputs=[X2]),
    "Upsample_bilinear_ratio": _same("Upsample", size=(7, 8), mode="bilinear", inputs=[X2]),
    "Upsample_linear": _same("Upsample", scale_factor=3, mode="linear", inputs=[X]),
    "Upsample_trilinear": _same("Upsample", scale_factor=2, mode="trilinear", inputs=[X3]),
    "UpsamplingNearest2d": _same("UpsamplingNearest2d", scale_factor=3, inputs=[X2]),
    "UpsamplingBilinear2d": _same("UpsamplingBilinear2d", size=(6, 8), inputs=[X2]),
    "ConvTranspose1d_output_padding": _same("ConvTranspose1d", 4, 3, 3, stride=2, padding=1, output_padding=1,
                                            inputs=[X], cpu=True),
    "ConvTranspose2d": _same("ConvTranspose2d", 3, 2, 3, inputs=[X2], cpu=True),
    "ConvTranspose2d_strides": _same("ConvTranspose2d", 3, 2, (3, 2), stride=(2, 3), padding=(1, 0),
                                     output_padding=(1, 2), inputs=[X2], cpu=True),
    "ConvTranspose3d": _same("ConvTranspose3d", 4, 2, 2, stride=2, output_padding=1, bias=False, inputs=[X3],
                             cpu=True),
    # nn/extended.py
    "LPPool1d_signed": _same("LPPool1d", 1, 2, inputs=[XL]),
    "LPPool2d": _same("LPPool2d", 2, 2, inputs=[POS2]),
    "LPPool3d": _same("LPPool3d", 1.5, (1, 2, 2), (1, 1, 2), inputs=[POS3]),
    "AlphaDropout_eval": _same("AlphaDropout", 0.3, inputs=[X]),
    "FeatureAlphaDropout_eval": _same("FeatureAlphaDropout", 0.3, inputs=[X2]),
    "EmbeddingBag_mean": _same("EmbeddingBag", 10, 4, inputs=[_ints(10, 3, 5)], opts={"fixed": (0,)}, cpu=True),
    "EmbeddingBag_sum_offsets_weights": _same("EmbeddingBag", 10, 4, "sum",
                                              inputs=[_ints(10, 7), np.array([0, 2, 2, 6]), _f(7, seed=3)],
                                              opts={"fixed": (0, 1)}, cpu=True),
    "EmbeddingBag_max_empty_bag": _same("EmbeddingBag", 10, 4, "max", inputs=[_ints(10, 7), np.array([0, 3, 3, 5])],
                                        opts={"fixed": (0, 1)}, cpu=True),
    "Unfold": _same("Unfold", (2, 3), padding=1, stride=(1, 2), inputs=[X2]),
    "Unfold_dilation": _same("Unfold", 2, dilation=2, inputs=[X2]),
    "Fold": _same("Fold", (4, 5), (2, 2), inputs=[_f(2, 12, 12)]),
    "Fold_stride_padding": _same("Fold", (5, 6), 3, padding=1, stride=2, inputs=[_f(2, 18, 9)]),
    "MaxUnpool1d": _same("MaxUnpool1d", 2, inputs=[V1, I1], opts=FIXED_INDEX),
    "MaxUnpool1d_output_size": _same("MaxUnpool1d", 2, inputs=[V1, I1], opts={"fixed": (1,),
                                                                              "kw": {"output_size": (11,)}}),
    "MaxUnpool2d": _same("MaxUnpool2d", 2, inputs=[V2, I2], opts=FIXED_INDEX),
    "MaxUnpool3d": _same("MaxUnpool3d", (1, 2, 2), inputs=[V3, I3], opts=FIXED_INDEX),
    # nn/recurrent.py
    "RNN": _same("RNN", 5, 6, 2, inputs=[SEQ], cpu=True),
    "RNN_relu_nobias": _same("RNN", 5, 6, 1, bias=False, nonlinearity="relu", inputs=[SEQ], cpu=True),
    "LSTM": _same("LSTM", 5, 6, 2, inputs=[SEQ], cpu=True),
    "LSTM_h0": _same("LSTM", 5, 6, 2, inputs=[SEQ], opts={"kw": {"h0": (H0, C0)}}, cpu=True),
    "GRU": _same("GRU", 5, 6, 2, inputs=[SEQ], cpu=True),
    "GRU_h0": _same("GRU", 5, 6, 2, inputs=[SEQ], opts={"kw": {"h0": H0}}, cpu=True),
    "RNNCell": _same("RNNCell", 5, 6, inputs=[SEQ[:, 0], H0[0]], cpu=True),
    "LSTMCell": _same("LSTMCell", 5, 6, inputs=[SEQ[:, 0]], opts={"kw": {"hx": (H0[0], C0[0])}}, cpu=True),
    "GRUCell_nobias": _same("GRUCell", 5, 6, bias=False, inputs=[SEQ[:, 0], H0[1]], cpu=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_reference(name):
    check_layer(name, CASES[name])


def test_alpha_dropouts_in_training():
    """The alpha dropouts keep a standard normal input near mean 0 and
    variance 1, drop at rate p (whole channels for the feature form), and
    are the identity in evaluation."""
    torch.manual_seed(1)
    x = torch.randn(256, 64, 8)
    for cls in (ht.nn.AlphaDropout, ht.nn.FeatureAlphaDropout):
        y = cls(0.2)(x)
        assert abs(float(y.mean())) < 0.02 and abs(float(y.var()) - 1.0) < 0.05
        assert torch.equal(cls(0.2).eval()(x), x)
    y = ht.nn.FeatureAlphaDropout(0.2)(x)
    a = (0.8 + 1.7580993408473766 ** 2 * 0.8 * 0.2) ** -0.5
    dropped = torch.isclose(y, torch.full_like(y, -a * 1.7580993408473766 * 0.8)).all(-1)
    assert 0.15 < float(dropped.float().mean()) < 0.25


def test_layer_errors_are_the_references():
    with pytest.raises(ValueError, match="output_padding"):
        ht.nn.ConvTranspose2d(3, 2, 3, stride=2, output_padding=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ht.nn.AdaptiveMaxPool1d(3)(torch.zeros(1, 2, 10))
    with pytest.raises(ValueError, match="per-side"):
        ht.nn.ReflectionPad2d((1, 2, 3))
    with pytest.raises(ValueError, match="offsets"):
        ht.nn.EmbeddingBag(10, 4, device="cpu")(torch.tensor([1, 2, 3]), torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="per_sample_weights"):
        ht.nn.EmbeddingBag(10, 4, "mean", device="cpu")(torch.tensor([[1, 2]]), per_sample_weights=torch.ones(1, 2))
    with pytest.raises(ValueError, match="invalid max index"):
        ht.nn.MaxUnpool1d(2)(torch.from_numpy(V1), torch.from_numpy(I1), output_size=(9,))
    with pytest.raises(ValueError, match="between"):
        ht.nn.MaxUnpool1d(2)(torch.from_numpy(V1), torch.from_numpy(I1), output_size=(14,))
    with pytest.raises(ValueError, match="nonlinearity"):
        ht.nn.RNN(3, 4, nonlinearity="gelu", device="cpu")
    # the recurrent layers' parameter names and shapes are the reference's
    lstm = ht.nn.LSTM(5, 6, 2, device="cpu")
    ref = ref_ht.nn.LSTM(5, 6, 2).init(jax.random.key(0))
    from heat_tpu_torch.utils import convert

    assert jax.tree.map(np.shape, convert.to_reference(lstm)) == jax.tree.map(np.shape, ref)
