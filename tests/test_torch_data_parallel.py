"""The port's data-parallel training at world size 1 against heat_tpu's, on the CPU.

``DataParallel`` with each optimizer trains the MLP and a small ResNet 5
steps against the reference's ``make_train_step`` on the same weights
(carried by ``utils.convert``) and batches (a numpy seed), by the default
path and by ``overlap_sync``; the reference runs on a mesh of one device,
the port's world.  Then the non-finite guard, the ten learning-rate
schedules, the DataLoader's batches and its shuffle.

Tolerances, float32, against each tensor's largest magnitude:
- parameters after each of 5 steps: rtol 1e-5 (SGD) and 2e-5 (Adam and
  AdamW at eps 1e-4: an Adam step moves a parameter by up to lr/eps times
  a change of its gradient, and the two sides' gradients differ by float32
  noise; lr/eps = 10 keeps that within the limit), the loss rtol 1e-5;
- schedules: rtol 1e-5 and atol 1e-7 of the peak rate (the reference
  computes in float32, the port in float64);
- DataLoader batches: exactly.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import heat_tpu as ref_ht
from heat_tpu.core.communication import Communication as RefComm
from heat_tpu.nn import models as ref_models
from heat_tpu.optim import lr_scheduler as ref_sched

import heat_tpu_torch as ht
from heat_tpu_torch.optim import lr_scheduler as sched
from heat_tpu_torch.utils import convert

OPTIMIZERS = {
    "sgd_momentum_wd_nesterov": ("sgd", dict(lr=0.05, momentum=0.9, weight_decay=1e-4, nesterov=True), 1e-5),
    "sgd_plain": ("sgd", dict(lr=0.1), 1e-5),
    "adam": ("adam", dict(lr=1e-3, eps=1e-4), 2e-5),
    "adamw": ("adamw", dict(lr=1e-3, eps=1e-4, weight_decay=0.05), 2e-5),
}


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
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()), err_msg=msg)


def _tree_close(module, want, rtol):
    got, want = convert._flatten(convert.to_reference(module)), convert._flatten(_np(want))
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], rtol, key)


def _model(kind):
    """(reference model, its params, the port's module of the same weights, batch shape)."""
    if kind == "mlp":
        rm = ref_models.mlp((20, 16, 12, 5))
        params = rm.init(jax.random.key(1))
        return rm, params, convert.mlp_from_reference(_np(params), (20, 16, 12, 5)), (24, 20)
    rm = ref_models.resnet((1, 1), width=4, num_classes=5)
    params = rm.init(jax.random.key(2))
    pm = convert.resnet_from_reference(_np(params), "resnet", stage_sizes=(1, 1), width=4, num_classes=5)
    return rm, params, pm, (8, 3, 8, 8)


def _batches(shape, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape).astype(np.float32), rng.integers(0, 5, shape[0]).astype(np.int32))
            for _ in range(steps)]


def _reference_run(rm, params, name, kw, batches, overlap):
    """The reference's make_train_step on a mesh of one device: (params, loss) after each step."""
    comm = RefComm(Mesh(np.asarray(jax.devices()[:1]), ("x",)))
    opt = ref_ht.optim.DataParallelOptimizer(name, **kw)
    dp = ref_ht.nn.DataParallel(rm, comm=comm, optimizer=opt)
    dp.parameters = params
    state = opt.init_state(params)
    step = dp.make_train_step(ref_ht.nn.functional.cross_entropy, donate=False, overlap_sync=overlap)
    out = []
    for x, y in batches:
        params, state, loss = step(params, state, jnp.asarray(x), jnp.asarray(y))
        out.append((_np(params), float(loss)))
    return out


@pytest.mark.parametrize("overlap", [False, True], ids=["default", "overlap_sync"])
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("kind", ["mlp", "resnet"])
def test_data_parallel_steps_match_reference(kind, opt_name, overlap):
    name, kw, rtol = OPTIMIZERS[opt_name]
    rm, params, pm, shape = _model(kind)
    batches = _batches(shape, 5, seed=len(opt_name))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _reference_run(rm, params, name, kw, batches, overlap)
    opt = ht.optim.DataParallelOptimizer(name, overlap_sync=overlap, **kw)
    dp = ht.nn.DataParallel(pm, optimizer=opt)
    assert dp.overlap_sync is overlap
    step = dp.make_train_step(ht.nn.functional.cross_entropy)
    for (x, y), (params_ref, loss_ref) in zip(batches, want):
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        _close(loss, loss_ref, 1e-5, "loss")
        _tree_close(pm, params_ref, rtol)
    assert opt.guard_stats() == {"steps": 5, "skipped": 0}


def test_world_one_step_is_torchs_own_step_bit_for_bit():
    """At world size 1 DataParallel hooks nothing: make_train_step and
    torch's own loop through the wrapper give the plain torch step's bits."""
    _, _, pm, shape = _model("resnet")
    plain = convert.resnet_from_reference(convert.to_reference(pm), "resnet", stage_sizes=(1, 1), width=4,
                                          num_classes=5)
    loop = convert.resnet_from_reference(convert.to_reference(pm), "resnet", stage_sizes=(1, 1), width=4,
                                         num_classes=5)
    x, y = (torch.from_numpy(a) for a in _batches(shape, 1)[0])
    step = ht.nn.DataParallel(pm, optimizer=ht.optim.DataParallelOptimizer("sgd", lr=0.1, momentum=0.9)) \
        .make_train_step(ht.nn.functional.cross_entropy)
    opt_plain = torch.optim.SGD(plain.parameters(), lr=0.1, momentum=0.9)
    dp_loop = ht.nn.DataParallel(loop)
    opt_loop = ht.optim.DataParallelOptimizer("sgd", loop.parameters(), lr=0.1, momentum=0.9)
    for _ in range(2):
        loss = step(x, y)
        opt_plain.zero_grad()
        loss_plain = ht.nn.functional.cross_entropy(plain(x), y)
        loss_plain.backward()
        opt_plain.step()
        opt_loop.zero_grad()
        ht.nn.functional.cross_entropy(dp_loop(x), y).backward()
        opt_loop.step()
        assert torch.equal(loss, loss_plain.detach())
    for (n, a), b, c in zip(pm.state_dict().items(), plain.state_dict().values(), loop.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c), n


def test_nonfinite_guard_skips_a_nan_batch():
    rm, params, pm, shape = _model("mlp")
    (x, y), = _batches(shape, 1)
    opt = ht.optim.DataParallelOptimizer("adam", lr=1e-2)
    step = ht.nn.DataParallel(pm, optimizer=opt).make_train_step(ht.nn.functional.cross_entropy)
    before = {n: t.clone() for n, t in pm.state_dict().items()}
    bad = x.copy()
    bad[3, 2] = np.nan
    assert not np.isfinite(float(step(torch.from_numpy(bad), torch.from_numpy(y))))
    assert all(torch.equal(t, before[n]) for n, t in pm.state_dict().items())
    assert opt.guard_stats() == {"steps": 1, "skipped": 1} and not opt.state
    step(torch.from_numpy(x), torch.from_numpy(y))
    assert opt.guard_stats() == {"steps": 2, "skipped": 1}
    # the reference's guard skips the same batch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt_r = ref_ht.optim.DataParallelOptimizer("adam", lr=1e-2)
        dp_r = ref_ht.nn.DataParallel(rm, comm=RefComm(Mesh(np.asarray(jax.devices()[:1]), ("x",))),
                                      optimizer=opt_r)
        state = opt_r.init_state(params)
        p2, state, _ = dp_r.make_train_step(ref_ht.nn.functional.cross_entropy, donate=False)(
            params, state, jnp.asarray(bad), jnp.asarray(y))
    assert opt_r.guard_stats(state) == {"steps": 1, "skipped": 1}
    _close(convert._flatten(_np(p2))["0.weight"], convert._flatten(_np(params))["0.weight"], 0.0)


def test_optimizer_specs_and_schedules_as_lr():
    """SGD/Adam/AdamW build torch optimizers over params, or specs built on
    attach; a schedule as lr steps through LambdaLR after each update."""
    p = [torch.nn.Parameter(torch.ones(3))]
    assert isinstance(ht.optim.SGD(p, lr=0.1, momentum=0.9), torch.optim.SGD)
    assert isinstance(ht.optim.Adam(p), torch.optim.Adam) and isinstance(ht.optim.AdamW(p), torch.optim.AdamW)
    spec = ht.optim.SGD(lr=sched.StepLR(0.1, 2, 0.5))
    opt = ht.optim.DataParallelOptimizer(spec)
    with pytest.raises(RuntimeError):
        opt.torch_optimizer
    _, _, pm, shape = _model("mlp")
    step = ht.nn.DataParallel(pm, optimizer=opt).make_train_step(ht.nn.functional.cross_entropy)
    lrs = []
    for x, y in _batches(shape, 5):
        lrs.append(opt.param_groups[0]["lr"])
        step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(lrs, [0.1, 0.1, 0.05, 0.05, 0.025])
    with pytest.raises(ValueError):
        ht.optim.DataParallelOptimizer("rmsprop", p)
    with pytest.raises(RuntimeError):
        ht.nn.DataParallel(pm).make_train_step(ht.nn.functional.cross_entropy)


def test_daso_replicas_carry_over_from_the_reference():
    """``daso_from_reference``: the reference DASO's parameters stacked over
    its groups; this rank (world size 1, rank 0) takes group 0 // ici."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rm = ref_models.mlp((20, 16, 12, 5))
        daso = ref_ht.optim.DASO(ref_ht.optim.DataParallelOptimizer("sgd", lr=0.1),
                                 mesh=Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici")))
        stacked = _np(daso.init(rm, key=jax.random.key(1)))
    stacked = jax.tree.map(lambda a: a + np.arange(2, dtype=a.dtype).reshape((2,) + (1,) * (a.ndim - 1)), stacked)
    pm = convert.daso_from_reference(stacked, ht.nn.models.mlp((20, 16, 12, 5)), ici=2)
    want = convert._flatten(jax.tree.map(lambda a: a[0], stacked))
    got = convert._flatten(convert.to_reference(pm))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


SCHEDULES = {
    "StepLR": dict(lr=0.1, step_size=7, gamma=0.5),
    "ExponentialLR": dict(lr=0.1, gamma=0.93),
    "CosineAnnealingLR": dict(lr=0.1, T_max=30, eta_min=0.001),
    "LambdaLR": dict(lr=0.1, lr_lambda=lambda s: 1.0 / (1.0 + s)),
    "MultiStepLR": dict(lr=0.1, milestones=[5, 12, 12, 40], gamma=0.3),
    "ConstantLR": dict(lr=0.1, factor=0.25, total_iters=9),
    "LinearLR": dict(lr=0.1, start_factor=0.1, end_factor=0.9, total_iters=20),
    "PolynomialLR": dict(lr=0.1, total_iters=30, power=2.0),
    "CosineAnnealingWarmRestarts": dict(lr=0.1, T_0=5, T_mult=3, eta_min=0.002),
    "OneCycleLR": dict(lr=0.1, total_steps=45, pct_start=0.3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    kw = SCHEDULES[name]
    ref, port = getattr(ref_sched, name)(**kw), getattr(sched, name)(**kw)
    want = np.array([float(ref(s)) for s in range(51)])
    got = np.array([port(s) for s in range(51)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * kw["lr"])


def test_warm_restarts_with_unit_multiplier():
    ref, port = ref_sched.CosineAnnealingWarmRestarts(0.1, 6), sched.CosineAnnealingWarmRestarts(0.1, 6)
    np.testing.assert_allclose([port(s) for s in range(51)], [float(ref(s)) for s in range(51)], rtol=1e-5,
                               atol=1e-8)


def _data(n=23, d=3, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:, 0] = np.arange(n)  # each row names its original index
    return x, (np.arange(n) % 7).astype(np.int32)


@pytest.mark.parametrize("batch_size,drop_last", [(5, False), (5, True), (23, False), (30, False), (1, False)])
def test_dataloader_batches_match_reference(batch_size, drop_last):
    x, y = _data()
    loader = ht.utils.data.DataLoader(ht.utils.data.Dataset(ht.array(x, split=0), labels=ht.array(y, split=0)),
                                      batch_size=batch_size, drop_last=drop_last)
    ref_loader = ref_ht.utils.data.DataLoader(
        ref_ht.utils.data.Dataset(ref_ht.array(x, split=0), labels=ref_ht.array(y, split=0)),
        batch_size=batch_size, drop_last=drop_last)
    got, want = list(loader), list(ref_loader)
    assert len(got) == len(want) == len(loader) == len(ref_loader)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.split == 0 and gx.shape == tuple(wx.shape)
        np.testing.assert_array_equal(gx.numpy(), wx.numpy())
        np.testing.assert_array_equal(gy.numpy(), wy.numpy())


def _shuffled_batches(loader):
    return [(bx.numpy(), by.numpy()) for bx, by in loader]


def test_shuffle_is_a_permutation_that_keeps_labels_aligned():
    x, y = _data(41)
    ds = ht.utils.data.Dataset(ht.array(x, split=0), labels=ht.array(y, split=0))
    loader = ht.utils.data.DataLoader(ds, batch_size=6, shuffle=True)
    epochs = [_shuffled_batches(loader) for _ in range(2)]
    for batches in epochs:
        rows = np.concatenate([bx for bx, _ in batches])
        labels = np.concatenate([by for _, by in batches])
        assert sorted(rows[:, 0].astype(int)) == list(range(41))
        np.testing.assert_array_equal(labels, y[rows[:, 0].astype(int)])
        np.testing.assert_array_equal(rows, x[rows[:, 0].astype(int)])
    assert not np.array_equal(epochs[0][0][0], epochs[1][0][0])  # each epoch draws anew
    # the same seed gives the same epochs; ishuffle gives the same batches
    again = ht.utils.data.DataLoader(ht.utils.data.Dataset(ht.array(x, split=0), labels=ht.array(y, split=0),
                                                           ishuffle=True), batch_size=6, shuffle=True)
    for batches in epochs:
        for (a, b), (c, d) in zip(batches, _shuffled_batches(again)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    # the free functions and the arrays in the current order
    before = ds.arrays[0].numpy()
    ht.utils.data.dataset_shuffle(ds)
    after = ds.arrays[0].numpy()
    assert sorted(after[:, 0]) == sorted(before[:, 0]) and not np.array_equal(after, before)
    ht.utils.data.dataset_ishuffle(ds)
    ds.ishuffle_finish()
    np.testing.assert_array_equal(ds[2:5][1].numpy(), y[ds[2:5][0].numpy()[:, 0].astype(int)])


def test_mnist_config_trains_at_world_one():
    """BASELINE config 3 on 16384 of its 60000 rows: Flatten + 784-128-64-10
    MLP with ReLU, Adam lr 1e-3, DataLoader(batch_size=256, shuffle=True),
    3 epochs (192 steps) on MNIST-shaped synthetic data: the loss falls and
    the train accuracy passes 0.9."""
    rng = np.random.default_rng(0)
    n = 16384
    labels = rng.integers(0, 10, n).astype(np.int32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    cx, cy = 4 + 2.2 * (labels % 5), 7 + 11 * (labels // 5)
    imgs = np.exp(-((xx[None] - cx[:, None, None]) ** 2 + (yy[None] - cy[:, None, None]) ** 2) / 14.0)
    imgs = (imgs + rng.normal(0, 0.05, imgs.shape)).astype(np.float32)
    ds = ht.utils.data.Dataset(ht.array(imgs, split=0), labels=ht.array(labels, split=0))
    loader = ht.utils.data.DataLoader(ds, batch_size=256, shuffle=True)
    torch.manual_seed(0)
    model = ht.nn.Sequential(ht.nn.Flatten(), ht.nn.Linear(784, 128), ht.nn.ReLU(), ht.nn.Linear(128, 64),
                             ht.nn.ReLU(), ht.nn.Linear(64, 10))
    opt = ht.optim.DataParallelOptimizer("adam", lr=1e-3)
    dp = ht.nn.DataParallel(model, optimizer=opt)
    step = dp.make_train_step(ht.nn.functional.cross_entropy)
    losses = [float(step(xb, yb)) for _ in range(3) for xb, yb in loader]
    assert losses[-1] < losses[0]
    with torch.no_grad():
        acc = float((dp.eval()(torch.from_numpy(imgs)).argmax(1).numpy() == labels).mean())
    assert acc > 0.9
