"""heat_tpu_torch.utils.memledger against heat_tpu.utils.memledger, case by case.

Each case runs the same steps through both ledgers: the reference's over
jax arrays, the port's over torch tensors of the same shapes, on the CPU.
Both give the same live and peak bytes, categories, window deltas and
flight-ring records; the port keys an entry by its tensor's storage, so a
view of a registered tensor does not count twice.  The port's checkpoint
loads register ``param`` entries as the reference's do.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu
from heat_tpu.utils import faults as ref_faults
from heat_tpu.utils import flightrec as ref_flightrec
from heat_tpu.utils import memledger as ref_ml

import heat_tpu_torch as htt
from heat_tpu_torch.utils import faults as port_faults
from heat_tpu_torch.utils import flightrec as port_flightrec
from heat_tpu_torch.utils import memledger as port_ml

SIDES = {
    "reference": (ref_ml, lambda shape: jnp.zeros(shape, jnp.float32), ref_faults, ref_flightrec),
    "port": (port_ml, lambda shape: torch.zeros(shape, dtype=torch.float32), port_faults, port_flightrec),
}


@pytest.fixture(autouse=True)
def fresh_ledgers():
    prev = htt.get_device()
    htt.use_device("cpu")
    for ml, *_ in SIDES.values():
        ml._reset_for_tests()
        ml.enable()
    yield
    for ml, _, _, fr in SIDES.values():
        ml.disable()
        ml._reset_for_tests()
        fr.disable()
    htt.use_device(prev)


def both(fn):
    """``fn(ml, make, faults, flightrec)`` on each side; the two results."""
    return [fn(*SIDES[s]) for s in ("reference", "port")]


def test_register_counts_and_weakref_decrements():
    def case(ml, make, *_):
        a, b = make((16, 8)), make((4,))
        ml.register(a, op="a", site="factory")
        ml.register(b, op="b", site="factory")
        live = ml.live_bytes()
        del a
        gc.collect()
        return live, ml.live_bytes(), ml.peak_bytes(), len(ml.top_buffers())

    ref, port = both(case)
    assert ref == port == (16 * 8 * 4 + 16, 16, 16 * 8 * 4 + 16, 1)


def test_register_is_idempotent_and_consume_once():
    def case(ml, make, *_):
        a = make((32,))
        ml.register(a)
        ml.register(a)
        once = ml.live_bytes()
        ml.consume(a)
        ml.consume(a)
        return once, ml.live_bytes(), ml.counters()["mem.registered.total"]

    ref, port = both(case)
    assert ref == port == (128, 0, 1)


def test_port_view_of_a_registered_storage_counts_once():
    a = torch.zeros((8, 8))
    port_ml.register(a, category="param")
    port_ml.register(a[2:4])
    port_ml.register(a.view(-1))
    assert port_ml.live_bytes() == 256
    assert port_ml.category_of(a[1]) == "param"


def test_transfer_moves_the_entry_without_double_count():
    def case(ml, make, *_):
        old, new = make((64,)), make((64,))
        ml.register(old, category="activation")
        ml.transfer(old, new, op="update")
        return ml.live_bytes(), ml.peak_bytes(), ml.category_of(new), ml.category_of(old)

    ref, port = both(case)
    assert ref == port == (256, 256, "activation", None)


def test_categories_inferred_explicit_and_scoped():
    def case(ml, make, *_):
        a, b, c, d = (make((8,)) for _ in range(4))
        ml.register(a, site="ckpt")
        ml.register(b, category="opt-state")
        with ml.category("transient"):
            ml.register(c)
        ml.register(d)
        ml.consume(b)
        return ([ml.category_of(x) for x in (a, c, d)], ml.live_by_category(), ml.peak_by_category())

    ref, port = both(case)
    assert ref == port
    assert ref[0] == ["param", "transient", "activation"]
    assert ref[2]["opt-state"] == 32 and "opt-state" not in ref[1]


def test_peak_window_sees_its_own_maximum():
    def case(ml, make, *_):
        keep = make((100,))
        ml.register(keep)
        with ml.peak_window() as w:
            tmp = make((50,))
            ml.register(tmp)
            ml.consume(tmp)
            inner = make((10,))
            ml.register(inner)
        return w["peak"] - w["base"], ml.live_bytes()

    ref, port = both(case)
    assert ref == port == (200, 440)


def test_is_oom_shapes():
    inj = port_faults.TransientFault("injected fault at site 'mem.alloc'")
    assert port_ml.is_oom(inj) and ref_ml.is_oom(inj)
    assert port_ml.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not port_ml.is_oom(RuntimeError("shape mismatch"))
    assert ref_ml.is_oom(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))


def test_alloc_check_fault_and_oom_dump_land_in_the_ring(tmp_path):
    def case(ml, make, faults, fr):
        side = tmp_path / ("ref" if ml is ref_ml else "port")
        path = fr.enable(str(side), rank=0)
        big, small = make((256,)), make((16,))
        ml.register(big, op="big", category="param")
        ml.register(small, op="small")
        with faults.inject("mem.alloc", fail=1):
            with pytest.raises(faults.TransientFault) as ei:
                ml.alloc_check(4096, "comm.allreduce.bucket")
        assert ml.note_oom(ei.value, "comm.allreduce.bucket", None)
        fr.sync()
        recs = [r for r in ref_flightrec.read_ring(path)["records"] if r["k"] in ("mem", "membuf")]
        head = next(r for r in recs if r.get("oom"))
        bufs = [(r["op"], r["nb"], r["cat"]) for r in recs if r["k"] == "membuf"]
        return head["req"], head["where"], head["live"], bufs, ml.counters()["mem.oom.dumps"]

    ref, port = both(case)
    assert ref == port
    assert ref[0] == 4096 and ref[3][0] == ("big", 1024, "param")


def test_device_memory_stats_absent_on_the_cpu():
    assert port_ml.device_memory_stats() is None


def test_checkpoint_loads_register_params_like_the_reference(tmp_path):
    x = np.arange(48, dtype=np.float32).reshape(12, 4)
    ref_dir, port_dir = str(tmp_path / "r"), str(tmp_path / "p")
    heat_tpu.save_array_checkpoint(heat_tpu.array(x, split=0), ref_dir)
    htt.save_array_checkpoint(htt.array(x, split=0), port_dir)
    r = heat_tpu.load_array_checkpoint(ref_dir)
    p = htt.load_array_checkpoint(port_dir)
    assert ref_ml.live_by_category().get("param", 0) > 0
    assert port_ml.category_of(p.larray) == "param"
    assert port_ml.live_by_category() == {"param": x.nbytes}
    tree = {"w": torch.ones(3, 5), "b": torch.zeros(5)}
    htt.save_checkpoint(tree, str(tmp_path / "tree"))
    back = htt.load_checkpoint(tree, str(tmp_path / "tree"))
    assert port_ml.category_of(back["w"]) == port_ml.category_of(back["b"]) == "param"
    del r
