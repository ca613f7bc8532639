"""The port's activations, modules and losses against heat_tpu's, on the CPU.

One case a layer and configuration (``CASES``): the reference module's
``init`` gives the parameters, ``convert.load_reference`` carries them
into the port's module, and the same numpy inputs (seeded) go through the
reference's ``apply`` and the port's ``forward``; then the same random
cotangent through ``jax.vjp`` and torch's autograd, for every parameter
and every float input.  Tolerance, float32: rtol 1e-5 and atol 1e-5 on
values and gradients (the same expression in another library; a loss's
mean adds float32 roundings of a sum of at most 120 terms).  The layers
whose training draws random numbers (``RReLU``, the channel dropouts) are
held in evaluation mode here and by their statistics in training
(``test_random_layers_in_training``), since torch's generator and
``jax.random`` draw different numbers.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ref_ht
from heat_tpu.nn import functional as ref_F

import heat_tpu_torch as ht
from heat_tpu_torch.utils import convert

RTOL = ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _f(*shape, seed=0, scale=1.0, shift=0.0):
    return (_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def _u(*shape, seed=0, lo=0.05, hi=0.95):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _sign(*shape, seed=0):
    return np.where(_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _ints(hi, *shape, seed=0):
    return _rng(seed).integers(0, hi, shape).astype(np.int64)


X = _f(3, 4, 5)  # (N, C, L)
X2 = _f(2, 3, 4, 5, seed=1)  # (N, C, H, W)
X3 = _f(2, 4, 3, 4, 5, seed=2)  # (N, C, D, H, W)
ROWS = _f(6, 8, seed=3)

# name: (reference module, port module, inputs, options)
# options: "train" runs both in training (reference apply(train=True)); "eval" holds the port in eval mode
CASES = {
    # activations (nn/activations.py) and the activations of nn/modules.py
    "ELU": (lambda r: r.ELU(0.7), lambda p: p.ELU(0.7), [X], {}),
    "CELU": (lambda r: r.CELU(1.3), lambda p: p.CELU(1.3), [X], {}),
    "SELU": (lambda r: r.SELU(), lambda p: p.SELU(), [X], {}),
    "SiLU": (lambda r: r.SiLU(), lambda p: p.SiLU(), [X], {}),
    "Mish": (lambda r: r.Mish(), lambda p: p.Mish(), [X], {}),
    "ReLU6": (lambda r: r.ReLU6(), lambda p: p.ReLU6(), [X * 4], {}),
    "LeakyReLU": (lambda r: r.LeakyReLU(), lambda p: p.LeakyReLU(), [X], {}),
    "LeakyReLU_0.2": (lambda r: r.LeakyReLU(0.2), lambda p: p.LeakyReLU(0.2), [X], {}),
    "LogSigmoid": (lambda r: r.LogSigmoid(), lambda p: p.LogSigmoid(), [X], {}),
    "Softplus": (lambda r: r.Softplus(), lambda p: p.Softplus(), [X], {}),
    "Softplus_beta_threshold": (lambda r: r.Softplus(2.0, 1.5), lambda p: p.Softplus(2.0, 1.5), [X], {}),
    "Softsign": (lambda r: r.Softsign(), lambda p: p.Softsign(), [X], {}),
    "Tanhshrink": (lambda r: r.Tanhshrink(), lambda p: p.Tanhshrink(), [X], {}),
    "Hardtanh": (lambda r: r.Hardtanh(-0.5, 0.8), lambda p: p.Hardtanh(-0.5, 0.8), [X], {}),
    "Hardswish": (lambda r: r.Hardswish(), lambda p: p.Hardswish(), [X * 3], {}),
    "Hardsigmoid": (lambda r: r.Hardsigmoid(), lambda p: p.Hardsigmoid(), [X * 3], {}),
    "Hardshrink": (lambda r: r.Hardshrink(), lambda p: p.Hardshrink(), [X], {}),
    "Softshrink": (lambda r: r.Softshrink(0.3), lambda p: p.Softshrink(0.3), [X], {}),
    "Threshold": (lambda r: r.Threshold(0.1, -2.0), lambda p: p.Threshold(0.1, -2.0), [X], {}),
    "GLU": (lambda r: r.GLU(), lambda p: p.GLU(), [_f(3, 8)], {}),
    "GLU_dim1": (lambda r: r.GLU(1), lambda p: p.GLU(1), [X2[:, :2]], {}),
    "Softmin": (lambda r: r.Softmin(), lambda p: p.Softmin(), [X], {}),
    "PReLU": (lambda r: r.PReLU(), lambda p: p.PReLU(device="cpu"), [X], {}),
    "PReLU_channels": (lambda r: r.PReLU(4, 0.1), lambda p: p.PReLU(4, 0.1, device="cpu"), [_f(3, 4, 5)], {}),
    "RReLU_eval": (lambda r: r.RReLU(0.1, 0.3), lambda p: p.RReLU(0.1, 0.3), [X], {"eval": True}),
    "ReLU": (lambda r: r.ReLU(), lambda p: p.ReLU(), [X], {}),
    "GELU_tanh": (lambda r: r.GELU("tanh"), lambda p: p.GELU("tanh"), [X], {}),
    # the rest of nn/modules.py
    "Softmax": (lambda r: r.Softmax(), lambda p: p.Softmax(), [X], {}),
    "Softmax_dim1": (lambda r: r.Softmax(1), lambda p: p.Softmax(1), [X], {}),
    "LogSoftmax": (lambda r: r.LogSoftmax(), lambda p: p.LogSoftmax(), [X], {}),
    "Dropout1d_eval": (lambda r: r.Dropout1d(0.5), lambda p: p.Dropout1d(0.5), [X], {"eval": True}),
    "Dropout2d_eval": (lambda r: r.Dropout2d(0.5), lambda p: p.Dropout2d(0.5), [X2], {"eval": True}),
    "Dropout3d_eval": (lambda r: r.Dropout3d(0.5), lambda p: p.Dropout3d(0.5), [X3], {"eval": True}),
    "Unflatten": (lambda r: r.Unflatten(1, (2, 2)), lambda p: p.Unflatten(1, (2, 2)), [X], {}),
    "BatchNorm3d_train": (lambda r: r.BatchNorm3d(4), lambda p: p.BatchNorm3d(4, device="cpu"), [X3],
                          {"train": True}),
    "BatchNorm3d_eval": (lambda r: r.BatchNorm3d(4), lambda p: p.BatchNorm3d(4, device="cpu"), [X3],
                         {"eval": True}),
    "RMSNorm": (lambda r: r.RMSNorm(5), lambda p: p.RMSNorm(5, device="cpu"), [X], {}),
    "RMSNorm_eps_2d": (lambda r: r.RMSNorm((4, 5), eps=1e-3), lambda p: p.RMSNorm((4, 5), eps=1e-3, device="cpu"),
                       [X], {}),
    "GroupNorm": (lambda r: r.GroupNorm(2, 4), lambda p: p.GroupNorm(2, 4, device="cpu"), [X3], {}),
    "GroupNorm_noaffine": (lambda r: r.GroupNorm(3, 3, affine=False),
                           lambda p: p.GroupNorm(3, 3, affine=False, device="cpu"), [X2], {}),
    # losses (nn/losses.py)
    "MSELoss_sum": (lambda r: r.MSELoss("sum"), lambda p: p.MSELoss("sum"), [ROWS, _f(6, 8, seed=4)], {}),
    "BCELoss": (lambda r: r.BCELoss(), lambda p: p.BCELoss(), [_u(6, 8), _u(6, 8, seed=5)], {}),
    "BCELoss_clipped": (lambda r: r.BCELoss("none"), lambda p: p.BCELoss("none"),
                        [np.array([0.0, 1e-9, 0.5, 1.0], np.float32), np.array([1.0, 0.0, 0.3, 0.0], np.float32)],
                        {}),
    "BCEWithLogitsLoss": (lambda r: r.BCEWithLogitsLoss(), lambda p: p.BCEWithLogitsLoss(),
                          [ROWS * 3, _u(6, 8, seed=5)], {}),
    "HuberLoss": (lambda r: r.HuberLoss(delta=0.5), lambda p: p.HuberLoss(delta=0.5), [ROWS, _f(6, 8, seed=4)], {}),
    "SmoothL1Loss": (lambda r: r.SmoothL1Loss(beta=0.7), lambda p: p.SmoothL1Loss(beta=0.7),
                     [ROWS, _f(6, 8, seed=4)], {}),
    "SmoothL1Loss_beta0": (lambda r: r.SmoothL1Loss("sum", beta=0.0), lambda p: p.SmoothL1Loss("sum", beta=0.0),
                           [ROWS, _f(6, 8, seed=4)], {}),
    "SoftMarginLoss": (lambda r: r.SoftMarginLoss(), lambda p: p.SoftMarginLoss(), [ROWS, _sign(6, 8)], {}),
    "HingeEmbeddingLoss": (lambda r: r.HingeEmbeddingLoss(0.5, "sum"), lambda p: p.HingeEmbeddingLoss(0.5, "sum"),
                           [ROWS, _sign(6, 8)], {}),
    "MarginRankingLoss": (lambda r: r.MarginRankingLoss(0.2), lambda p: p.MarginRankingLoss(0.2),
                          [_f(7), _f(7, seed=4), _sign(7)], {}),
    "CosineEmbeddingLoss": (lambda r: r.CosineEmbeddingLoss(0.1), lambda p: p.CosineEmbeddingLoss(0.1),
                            [ROWS, _f(6, 8, seed=4), _sign(6)], {}),
    "GaussianNLLLoss": (lambda r: r.GaussianNLLLoss(), lambda p: p.GaussianNLLLoss(),
                        [ROWS, _f(6, 8, seed=4), _u(6, 8, seed=6, lo=1e-7, hi=2.0)], {}),
    "GaussianNLLLoss_full": (lambda r: r.GaussianNLLLoss(full=True, reduction="sum"),
                             lambda p: p.GaussianNLLLoss(full=True, reduction="sum"),
                             [ROWS, _f(6, 8, seed=4), _u(6, 8, seed=6, lo=0.1, hi=2.0)], {}),
    "PoissonNLLLoss": (lambda r: r.PoissonNLLLoss(), lambda p: p.PoissonNLLLoss(),
                       [ROWS * 0.5, _ints(5, 6, 8).astype(np.float32)], {}),
    "PoissonNLLLoss_full": (lambda r: r.PoissonNLLLoss(log_input=False, full=True),
                            lambda p: p.PoissonNLLLoss(log_input=False, full=True),
                            [_u(6, 8, lo=0.1, hi=3.0), _ints(5, 6, 8).astype(np.float32)], {}),
    "TripletMarginLoss": (lambda r: r.TripletMarginLoss(), lambda p: p.TripletMarginLoss(),
                          [ROWS, _f(6, 8, seed=4), _f(6, 8, seed=5)], {}),
    "TripletMarginLoss_p1_swap": (lambda r: r.TripletMarginLoss(0.5, p=1.0, swap=True),
                                  lambda p: p.TripletMarginLoss(0.5, p=1.0, swap=True),
                                  [ROWS, _f(6, 8, seed=4), _f(6, 8, seed=5)], {}),
    "TripletMarginWithDistanceLoss": (lambda r: r.TripletMarginWithDistanceLoss(margin=0.3),
                                      lambda p: p.TripletMarginWithDistanceLoss(margin=0.3),
                                      [ROWS, _f(6, 8, seed=4), _f(6, 8, seed=5)], {}),
    "KLDivLoss": (lambda r: r.KLDivLoss(), lambda p: p.KLDivLoss(),
                  [np.log(_u(6, 8)), np.concatenate([_u(6, 7, seed=2), np.zeros((6, 1), np.float32)], 1)], {}),
    "KLDivLoss_batchmean_log_target": (lambda r: r.KLDivLoss("batchmean", log_target=True),
                                       lambda p: p.KLDivLoss("batchmean", log_target=True),
                                       [np.log(_u(6, 8)), np.log(_u(6, 8, seed=2))], {}),
    "MultiLabelSoftMarginLoss": (lambda r: r.MultiLabelSoftMarginLoss(), lambda p: p.MultiLabelSoftMarginLoss(),
                                 [ROWS, (_rng(3).random((6, 8)) < 0.4).astype(np.float32)], {}),
    "MultiMarginLoss": (lambda r: r.MultiMarginLoss(), lambda p: p.MultiMarginLoss(), [ROWS, _ints(8, 6)], {}),
    "MultiMarginLoss_p2": (lambda r: r.MultiMarginLoss(p=2, margin=0.5, reduction="none"),
                           lambda p: p.MultiMarginLoss(p=2, margin=0.5, reduction="none"), [ROWS, _ints(8, 6)], {}),
    "MultiLabelMarginLoss": (lambda r: r.MultiLabelMarginLoss(), lambda p: p.MultiLabelMarginLoss(),
                             [ROWS, np.array([[3, 0, -1, 1, 0, 0, 0, 0], [1, 2, 5, -1, 0, 0, 0, 0],
                                              [7, -1, 0, 0, 0, 0, 0, 0], [-1, 0, 0, 0, 0, 0, 0, 0],
                                              [0, 1, 2, 3, 4, 5, 6, 7], [2, 2, -1, 0, 0, 0, 0, 0]], np.int64)], {}),
    "CTCLoss": (lambda r: r.CTCLoss(), lambda p: p.CTCLoss(),
                [np.asarray(jax.nn.log_softmax(_f(12, 3, 6, seed=7), axis=-1)), _ints(5, 3, 4, seed=8) + 1,
                 np.array([12, 10, 9]), np.array([4, 3, 2])], {}),
    "CTCLoss_sum_blank2_infeasible": (lambda r: r.CTCLoss(blank=2, reduction="sum", zero_infinity=True),
                                      lambda p: p.CTCLoss(blank=2, reduction="sum", zero_infinity=True),
                                      [np.asarray(jax.nn.log_softmax(_f(6, 3, 5, seed=9), axis=-1)),
                                       np.array([[0, 1, 3, 4], [1, 1, 1, 0], [3, 4, 0, 0]]), np.array([6, 4, 5]),
                                       np.array([4, 3, 2])], {}),
}

# the integer inputs of a case (never differentiated): by position
INT_INPUTS = {"MultiMarginLoss": (1,), "MultiMarginLoss_p2": (1,), "MultiLabelMarginLoss": (1,),
              "CTCLoss": (1, 2, 3), "CTCLoss_sum_blank2_infeasible": (1, 2, 3)}
# inputs held fixed in the gradient check: targets, and a piecewise loss's kinks
FIXED_INPUTS = {name: (1,) for name in CASES if name.endswith("Loss") or "Loss_" in name}
FIXED_INPUTS.update({"MarginRankingLoss": (2,), "CosineEmbeddingLoss": (2,), "GaussianNLLLoss": (1,),
                     "GaussianNLLLoss_full": (1,), "BCELoss_clipped": (0, 1)})


for _name, _fixed in FIXED_INPUTS.items():
    CASES[_name][3]["fixed"] = tuple(sorted(set(_fixed) | set(INT_INPUTS.get(_name, ()))))


def _leaves(out):
    return [np.asarray(v) for v in jax.tree.leaves(out)]


def _tleaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _tleaves(o)]


def _as(v, conv):
    """A keyword's numpy arrays (in nested tuples) converted for one library."""
    if isinstance(v, tuple):
        return tuple(_as(a, conv) for a in v)
    return conv(v) if isinstance(v, np.ndarray) else v


def check_layer(name, case):
    """``case`` = (reference constructor, port constructor, inputs, options)
    held forward and backward (module docstring).  Options: ``fixed``, the
    input positions not differentiated; ``train``, both in training (the
    reference's ``apply(train=True)``); ``kw``, keywords of both calls."""
    rctor, pctor, inputs, opts = case
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rmod = rctor(ref_ht.nn)
    params = rmod.init(jax.random.key(3))
    pmod = pctor(ht.nn)
    convert.load_reference(pmod, jax.tree.map(np.asarray, params))
    pmod.train(bool(opts.get("train")))
    kw = opts.get("kw", {})
    pkw = {k: _as(v, lambda a: torch.from_numpy(np.array(a))) for k, v in kw.items()}
    rkw = {k: _as(v, jnp.asarray) for k, v in kw.items()}
    if opts.get("train"):
        rkw["train"] = True
    diff = [i for i in range(len(inputs)) if i not in set(opts.get("fixed", ()))]

    def ref_fn(p, *xs):
        full = list(inputs)
        for i, x in zip(diff, xs):
            full[i] = x
        return rmod.apply(p, *[jnp.asarray(a) for a in full], **rkw)

    xs = [jnp.asarray(inputs[i]) for i in diff]
    shapes = jax.eval_shape(ref_fn, params, *xs)
    # the gradient of <out, c> for a seeded cotangent c; one compiled program
    cots = jax.tree.map(lambda sh: np.asarray(_f(*sh.shape, seed=11)), shapes)

    def fwd_bwd(p, xs, c):
        out, vjp = jax.vjp(ref_fn, p, *xs)
        return out, vjp(c)

    want, r_grads = jax.jit(fwd_bwd)(params, xs, cots)
    t_in = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        t_in[i].requires_grad_(True)
    got = pmod(*t_in, **pkw)
    wl, gl = _leaves(want), _tleaves(got)
    assert len(wl) == len(gl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
    live = [(g, torch.from_numpy(c)) for g, c in zip(gl, jax.tree.leaves(cots)) if g.requires_grad]
    if live:
        torch.autograd.backward([g for g, _ in live], [c for _, c in live])
    flat_ref = convert._flatten(jax.tree.map(np.asarray, r_grads[0]))
    for pname, p in pmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy() if p.grad is not None else 0.0 * p.detach().numpy(),
                                   flat_ref[pname], rtol=RTOL, atol=ATOL, err_msg=f"{name}.{pname}")
    for k, i in enumerate(diff):
        np.testing.assert_allclose(t_in[i].grad.numpy() if t_in[i].grad is not None else 0.0 * inputs[i],
                                   np.asarray(r_grads[1 + k]), rtol=RTOL, atol=ATOL, err_msg=f"{name} input {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_layer_matches_reference(name):
    check_layer(name, CASES[name])


def test_random_layers_in_training():
    """RReLU's slopes lie in [lower, upper] (positives pass), the channel
    dropouts zero whole channels and scale the rest by 1 / (1 - p) at about
    the rate p, and eval mode is the identity (reference: ``train=False``)."""
    torch.manual_seed(0)
    x = torch.randn(64, 32, 4, 4)
    r = ht.nn.RReLU(0.1, 0.3)
    y = r(x)
    neg = x < 0
    slope = y[neg] / x[neg]
    assert bool((slope >= 0.1).all()) and bool((slope <= 0.3).all()) and torch.equal(y[~neg], x[~neg])
    assert 0.15 < float(slope.mean()) < 0.25 and float(slope.std()) > 0.03
    for cls, shape in ((ht.nn.Dropout1d, (64, 32, 16)), (ht.nn.Dropout2d, (64, 32, 4, 4)),
                       (ht.nn.Dropout3d, (64, 32, 2, 2, 4))):
        d = cls(0.25)
        xin = torch.rand(shape) + 0.5
        y = d(xin).reshape(64, 32, -1)
        zero = (y == 0).all(-1)
        assert bool(((y == 0) | torch.isclose(y, xin.reshape(64, 32, -1) / 0.75)).all())
        assert bool((zero | (y != 0).all(-1)).all())  # whole channels
        assert 0.2 < float(zero.float().mean()) < 0.3
        assert torch.equal(d.eval()(xin), xin)
        with pytest.raises(ValueError, match="expected"):
            cls(0.25).train()(xin[0])
    # the reference's eval behaviour
    rx = np.asarray(X)
    np.testing.assert_allclose(ht.nn.RReLU(0.1, 0.3).eval()(torch.from_numpy(rx)).numpy(),
                               np.asarray(ref_ht.nn.RReLU(0.1, 0.3).apply((), rx)), rtol=1e-6)


@pytest.mark.parametrize("name", ["binary_cross_entropy", "binary_cross_entropy_with_logits", "huber_loss",
                                  "smooth_l1_loss", "kl_div", "relu", "softmax", "log_softmax"])
def test_functional_matches_reference(name):
    a, b = _u(5, 7, seed=1), _u(5, 7, seed=2)
    if name in ("relu", "softmax", "log_softmax"):
        args = [_f(5, 7)]
    elif name == "kl_div":
        args = [np.log(a), b]
    elif name == "binary_cross_entropy":
        args = [a, b]
    else:
        args = [_f(5, 7) * 2, b]
    for kw in ({}, {"reduction": "sum"}) if len(args) == 2 else ({}, {"axis": 0}) if name != "relu" else ({},):
        want = np.asarray(getattr(ref_F, name)(*[jnp.asarray(v) for v in args], **kw))
        got = getattr(ht.nn.functional, name)(*[torch.from_numpy(v) for v in args], **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{name} {kw}")


def test_module_is_torch_and_constructor_errors():
    """``ht.nn.Module`` is ``torch.nn.Module``; the constructors refuse what the reference's refuse."""
    assert ht.nn.Module is torch.nn.Module and isinstance(ht.nn.GELU(), ht.nn.Module)
    with pytest.raises(ValueError, match="divisible"):
        ht.nn.GroupNorm(3, 4, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        ht.nn.KLDivLoss("avg")
    with pytest.raises(ValueError):
        ht.nn.MultiMarginLoss(p=3)
    with pytest.raises(ValueError, match="5-D"):
        ht.nn.BatchNorm3d(4, device="cpu")(torch.zeros(2, 4, 3))
    with pytest.raises(ValueError, match="padded 2-D"):
        ht.nn.CTCLoss()(torch.zeros(4, 2, 3), torch.zeros(4, dtype=torch.long), torch.tensor([4, 4]),
                        torch.tensor([2, 2]))
    assert ht.nn.PReLU(device="cpu").weight.device.type == "cpu"


def test_public_names_match_the_reference():
    """Every public name of ``heat_tpu.nn``, ``nn.functional`` and
    ``nn.models`` is in the port (the reference's imported modules aside),
    and ``parallel`` lacks exactly the runtime plane (ROADMAP A12)."""
    import heat_tpu.nn.functional
    import heat_tpu.nn.models

    def pub(m):
        return {n for n in dir(m) if not n.startswith("_")}

    assert pub(ref_ht.nn) - pub(ht.nn) == set()
    assert pub(heat_tpu.nn.functional) - pub(ht.nn.functional) == {"jax", "jnp", "DNDarray"}
    assert pub(heat_tpu.nn.models) - pub(ht.nn.models) == {"nn", "Sequence"}
    assert pub(ref_ht.parallel) - pub(ht.parallel) == {
        "AdmissionPredictor", "Federation", "Job", "JobJournal", "JobRejected", "JournalSchemaError", "Scheduler",
        "Supervisor", "SupervisorResult", "WorldHandle", "federation", "make_executor", "scheduler", "serving",
        "supervisor"}
