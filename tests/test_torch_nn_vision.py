"""The port's vision layers, losses, the MLP and the ResNets against heat_tpu's, on the CPU.

The reference's parameters (from its own ``init``) go into the port through
``utils.convert``; the same numpy inputs (a numpy seed) go to both.  Each
layer is held in its forward and in the gradients of sum(y * w) for a
random cotangent w, with respect to its input and its weights.

Tolerances, all float32, each against the largest magnitude of the
reference's tensor (``_close``: |got - want| <= rtol * (|want| + max|want|)):
- layers, their gradients and the losses: rtol 1e-5 (one convolution,
  pooling or normalization in another library: float32 sums in another
  order);
- the MLP and ResNets end to end (logits and every parameter's gradient):
  rtol 1e-4 (up to 16 stages of convolution and BatchNorm, each adding
  the layers' differences).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heat_tpu.nn import losses as ref_losses
from heat_tpu.nn.functional import cross_entropy as ref_cross_entropy
from heat_tpu.nn import models as ref_models
from heat_tpu.nn import modules as ref_nn

import heat_tpu_torch as ht
from heat_tpu_torch.nn import models
from heat_tpu_torch.utils import convert

LAYER_RTOL = 1e-5
MODEL_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    prev = ht.get_device()
    ht.use_device("cpu")
    yield
    ht.use_device(prev)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _close(got, want, rtol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=msg)


def _grads(module):
    """The port's parameter gradients as a reference pytree."""
    return convert._unflatten({n: p.grad.numpy() for n, p in module.named_parameters()})


def _tree_close(got, want, rtol):
    flat_got, flat_want = convert._flatten(got), convert._flatten(_np(want))
    flat_want = {k: v for k, v in flat_want.items() if not k.rsplit(".", 1)[-1].startswith("running_")}
    assert flat_got.keys() == flat_want.keys()
    for key in flat_want:
        _close(flat_got[key], flat_want[key], rtol, key)


def _run_both(ref_layer, port_layer, x, train=True, seed=0):
    """Forward of both, and the gradients of sum(y * w) for a random w:
    returns (y_ref, y_port, reference (dparams, dx), port dx)."""
    params = ref_layer.init(jax.random.key(seed))
    if port_layer is not None and jax.tree_util.tree_leaves(params):
        convert._load(port_layer, _np(params))
    y_ref = ref_layer.apply(params, jnp.asarray(x), train=train)
    w = np.random.default_rng(seed + 1).standard_normal(np.shape(y_ref)).astype(np.float32)
    grad_ref = jax.grad(lambda p, xx: jnp.sum(ref_layer.apply(p, xx, train=train) * w), argnums=(0, 1))(
        params, jnp.asarray(x))
    port_layer.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port_layer(xt)
    y.backward(torch.from_numpy(w))
    return y_ref, y, grad_ref, xt.grad


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


LAYERS = {
    "relu": (lambda: ref_nn.ReLU(), lambda: ht.nn.ReLU(), (4, 5, 6, 6)),
    "tanh": (lambda: ref_nn.Tanh(), lambda: ht.nn.Tanh(), (4, 7)),
    "sigmoid": (lambda: ref_nn.Sigmoid(), lambda: ht.nn.Sigmoid(), (4, 7)),
    "identity": (lambda: ref_nn.Identity(), lambda: ht.nn.Identity(), (3, 4)),
    "flatten": (lambda: ref_nn.Flatten(), lambda: ht.nn.Flatten(), (3, 2, 5, 5)),
    "conv3x3_pad1": (lambda: ref_nn.Conv2d(3, 8, 3, padding=1), lambda: ht.nn.Conv2d(3, 8, 3, padding=1),
                     (2, 3, 9, 9)),
    "conv1x1_stride2_nobias": (lambda: ref_nn.Conv2d(4, 6, 1, stride=2, bias=False),
                               lambda: ht.nn.Conv2d(4, 6, 1, stride=2, bias=False), (2, 4, 9, 9)),
    "conv7x7_stride2_pad3": (lambda: ref_nn.Conv2d(3, 5, 7, stride=2, padding=3, bias=False),
                             lambda: ht.nn.Conv2d(3, 5, 7, stride=2, padding=3, bias=False), (2, 3, 16, 16)),
    "conv_rect": (lambda: ref_nn.Conv2d(2, 3, (3, 1), stride=(2, 1), padding=(1, 0)),
                  lambda: ht.nn.Conv2d(2, 3, (3, 1), stride=(2, 1), padding=(1, 0)), (2, 2, 7, 5)),
    "maxpool2": (lambda: ref_nn.MaxPool2d(2), lambda: ht.nn.MaxPool2d(2), (2, 3, 8, 8)),
    "maxpool3_stride2": (lambda: ref_nn.MaxPool2d(3, stride=2), lambda: ht.nn.MaxPool2d(3, stride=2), (2, 3, 9, 9)),
    "avgpool2": (lambda: ref_nn.AvgPool2d(2), lambda: ht.nn.AvgPool2d(2), (2, 3, 8, 8)),
    "avgpool3_stride2": (lambda: ref_nn.AvgPool2d(3, 2), lambda: ht.nn.AvgPool2d(3, 2), (2, 3, 9, 9)),
    "adaptive1": (lambda: ref_nn.AdaptiveAvgPool2d(1), lambda: ht.nn.AdaptiveAvgPool2d(1), (2, 3, 8, 6)),
    "adaptive_2_3": (lambda: ref_nn.AdaptiveAvgPool2d((2, 3)), lambda: ht.nn.AdaptiveAvgPool2d((2, 3)),
                     (2, 3, 8, 6)),
    "adaptive_keep": (lambda: ref_nn.AdaptiveAvgPool2d((None, 2)), lambda: ht.nn.AdaptiveAvgPool2d((None, 2)),
                      (2, 3, 5, 6)),
    "batchnorm1d_2d": (lambda: ref_nn.BatchNorm1d(6), lambda: ht.nn.BatchNorm1d(6), (9, 6)),
    "batchnorm1d_3d": (lambda: ref_nn.BatchNorm1d(4), lambda: ht.nn.BatchNorm1d(4), (5, 4, 7)),
    "batchnorm2d": (lambda: ref_nn.BatchNorm2d(3), lambda: ht.nn.BatchNorm2d(3), (4, 3, 5, 5)),
    "batchnorm2d_noaffine": (lambda: ref_nn.BatchNorm2d(3, affine=False),
                             lambda: ht.nn.BatchNorm2d(3, affine=False), (4, 3, 5, 5)),
    "residual_identity": (lambda: ref_nn.Residual(ref_nn.Sequential(ref_nn.Conv2d(3, 3, 3, padding=1),
                                                                    ref_nn.ReLU())),
                          lambda: ht.nn.Residual(ht.nn.Sequential(ht.nn.Conv2d(3, 3, 3, padding=1), ht.nn.ReLU())),
                          (2, 3, 6, 6)),
    "residual_shortcut": (lambda: ref_nn.Residual(ref_nn.Conv2d(3, 4, 3, stride=2, padding=1),
                                                  ref_nn.Sequential(ref_nn.Conv2d(3, 4, 1, stride=2, bias=False),
                                                                    ref_nn.BatchNorm2d(4))),
                          lambda: ht.nn.Residual(ht.nn.Conv2d(3, 4, 3, stride=2, padding=1),
                                                 ht.nn.Sequential(ht.nn.Conv2d(3, 4, 1, stride=2, bias=False),
                                                                  ht.nn.BatchNorm2d(4))),
                          (2, 3, 8, 8)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_forward_and_gradients_match_reference(name):
    make_ref, make_port, shape = LAYERS[name]
    ref_layer, port_layer = make_ref(), make_port()
    x = _x(shape, seed=len(name))
    y_ref, y, (dp_ref, dx_ref), dx = _run_both(ref_layer, port_layer, x)
    _close(y, y_ref, LAYER_RTOL, "forward")
    _close(dx, dx_ref, LAYER_RTOL, "input gradient")
    if jax.tree_util.tree_leaves(dp_ref):
        _tree_close(_grads(port_layer), dp_ref, LAYER_RTOL)


@pytest.mark.parametrize("cls,shape", [("BatchNorm1d", (9, 6)), ("BatchNorm2d", (4, 6, 3, 5))])
def test_batchnorm_eval_and_update_stats_match_reference(cls, shape):
    ref_layer, port_layer = getattr(ref_nn, cls)(6, momentum=0.2), getattr(ht.nn, cls)(6, momentum=0.2)
    params = ref_layer.init(jax.random.key(0))
    params = dict(_np(params), weight=_x((6,), 1) + 1.0, bias=_x((6,), 2))
    convert._load(port_layer, params)
    x1, x2 = _x(shape, 3) * 2.0 + 0.5, _x(shape, 4)
    # update_stats: the running EMA with the ddof=1 variance, twice
    for xb in (x1, x2):
        params = ref_layer.update_stats(params, jnp.asarray(xb))
        port_layer.update_stats(torch.from_numpy(xb))
    _close(port_layer.running_mean, params["running_mean"], LAYER_RTOL, "running_mean")
    _close(port_layer.running_var, params["running_var"], LAYER_RTOL, "running_var")
    # evaluation normalizes with the running buffers
    port_layer.eval()
    _close(port_layer(torch.from_numpy(x2)), ref_layer.apply(params, jnp.asarray(x2), train=False), LAYER_RTOL)
    # training normalizes with the batch's biased variance and leaves the buffers alone
    port_layer.train()
    before = port_layer.running_var.clone()
    _close(port_layer(torch.from_numpy(x1)), ref_layer.apply(params, jnp.asarray(x1), train=True), LAYER_RTOL)
    assert torch.equal(port_layer.running_var, before)


def test_batchnorm_and_adaptive_pool_raise_as_the_reference():
    with pytest.raises(ValueError):
        ht.nn.AdaptiveAvgPool2d(3)(torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError):
        ref_nn.AdaptiveAvgPool2d(3).apply((), jnp.zeros((1, 2, 8, 8)))
    with pytest.raises(ValueError):
        ht.nn.BatchNorm2d(2)(torch.zeros(3, 2))
    with pytest.raises(ValueError):
        ht.nn.BatchNorm1d(2)(torch.zeros(3, 2, 2, 2))


def test_layers_are_built_on_the_default_device():
    ht.use_device("gpu")
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                ht.nn.Conv2d(1, 1, 3)
            with pytest.raises(RuntimeError):
                ht.nn.BatchNorm2d(2)
    finally:
        ht.use_device("cpu")
    assert ht.nn.Conv2d(1, 1, 3).weight.device.type == "cpu"
    assert ht.nn.BatchNorm2d(2).running_mean.device.type == "cpu"


@pytest.mark.parametrize("cls", ["MSELoss", "L1Loss", "CrossEntropyLoss", "NLLLoss"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_match_reference(cls, reduction):
    pred = _x((7, 5), 5)
    if cls in ("CrossEntropyLoss", "NLLLoss"):
        target = np.random.default_rng(6).integers(0, 5, 7).astype(np.int32)
        if cls == "NLLLoss":
            pred = np.asarray(jax.nn.log_softmax(jnp.asarray(pred), axis=-1))
    else:
        target = _x((7, 5), 6)
    want = getattr(ref_losses, cls)(reduction=reduction)(jnp.asarray(pred), jnp.asarray(target))
    got = getattr(ht.nn, cls)(reduction=reduction)(torch.from_numpy(pred), torch.from_numpy(target))
    _close(got, want, LAYER_RTOL)
    with pytest.raises(ValueError):
        getattr(ht.nn, cls)(reduction="max")


MODELS = {
    "mlp": (lambda: ref_models.mlp((48, 16, 12, 10)), lambda p: convert.mlp_from_reference(p, (48, 16, 12, 10)),
            (5, 48), "float32"),
    "resnet_1_1_w8": (lambda: ref_models.resnet((1, 1), width=8, num_classes=5),
                      lambda p: convert.resnet_from_reference(p, "resnet", stage_sizes=(1, 1), width=8,
                                                              num_classes=5),
                      (3, 3, 32, 32), "float32"),
    "resnet50_w8": (lambda: ref_models.resnet50(num_classes=7, width=8),
                    lambda p: convert._load(models.resnet50(num_classes=7, width=8).double(), p),
                    (4, 3, 32, 32), "float64"),
}
RTOL = {"float32": MODEL_RTOL, "float64": 1e-9}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logits_and_gradients_match_reference(name):
    """The MLP and the small ResNet in float32.  ResNet-50 in float64 on
    both sides: at 32 x 32 its last stage is 1 x 1, so each BatchNorm there
    normalizes 4 values a channel, and in float32 both libraries' gradients
    of some of those layers lie ~5e-2 from the float64 gradient (the same
    distance for both: the inputs, not either library, set it)."""
    make_ref, load, shape, dtype = MODELS[name]
    with jax.enable_x64(dtype == "float64"):
        rm = make_ref()
        params = rm.init(jax.random.key(3))
        x = _x(shape, 7).astype(dtype)
        classes = int(np.asarray(params[-1]["weight"]).shape[0]) if isinstance(params, list) else None
        y = np.random.default_rng(8).integers(0, classes, shape[0]).astype(np.int32)

        def loss_ref(p):
            return ref_cross_entropy(rm.apply(p, jnp.asarray(x), train=True), jnp.asarray(y))

        lval, g_ref = jax.jit(jax.value_and_grad(loss_ref))(params)
        logits_ref = jax.jit(lambda p: rm.apply(p, jnp.asarray(x), train=True))(params)
        pm = load(_np(params))
        pm.train()
        logits = pm(torch.from_numpy(x))
        assert logits.dtype == getattr(torch, dtype)
        _close(logits, logits_ref, RTOL[dtype], "logits")
        loss = ht.nn.functional.cross_entropy(logits, torch.from_numpy(y))
        _close(loss, lval, RTOL[dtype], "loss")
        loss.backward()
        _tree_close(_grads(pm), g_ref, RTOL[dtype])
        # the carried state comes back, running statistics included
        back = convert._flatten(convert.to_reference(pm))
        assert back.keys() == convert._flatten(_np(params)).keys()


def test_model_shapes_match_reference():
    """resnet50() at the DASO baseline's width: 1000 classes, the layer
    order and every parameter's shape of the reference (no padding in the
    stem's pool: 224 -> 112 -> 55)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        shapes_ref = jax.eval_shape(lambda k: ref_models.resnet50().init(k), jax.random.key(0))
    pm = models.resnet50()
    want = {k: tuple(v.shape) for k, v in convert._flatten(
        jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes_ref)).items()}
    got = {n: tuple(t.shape) for n, t in convert._reference_state(pm)}
    assert got == want
    assert sum(p.numel() for p in pm.parameters()) == 25_557_032
    with torch.no_grad():
        stem = pm[:4](torch.zeros(1, 3, 224, 224))
    assert tuple(stem.shape) == (1, 64, 55, 55)
    assert models.resnet50_ish is models.resnet34
