#!/usr/bin/env python3
"""Time the KMeans kernels and a KMeans fit of one checkout on a CUDA card.

    python3 scripts/kmeans_ab.py [--root DIR] [--reps N]

Imports ``heat_tpu_torch`` from DIR (a checkout of this repository; by
default the one holding this script), builds its kernels there, and drives
the KMeans main path of this checkout's ``chip_smoke.py`` on DIR's package,
in float32 and then bfloat16: ``create_clusters(1e8, 32, 64)``, one
20-iteration fit and predict from a random init (``main_fit``, the launch
counts zeroed just before), one Lloyd step against the torch path's and the
fit's inertia against it (``compare_with_torch_path``), both kernels
against their plain versions on the fitted centres
(``check_at_main_shape``), then ``assign`` and ``em_stats`` timed with CUDA
events (``time_kernels``).  The kernels are built before the first fit, so
no fit's seconds hold the build.  It prints one JSON line: the card (nvidia-smi's
name and power limit), DIR, each kernel's ms per launch and the fit's
seconds and iterations per second, by dtype.  A checkout that fails a check
fails the run.  Two checkouts compare only within one run on one card, run
in turns, the parent unpacked by ``git archive`` under ``build/`` (which
git ignores):

    mkdir -p build/parent && git archive PARENT | tar -x -C build/parent  # PARENT: the commit before the change
    for r in build/parent . . build/parent; do python3 scripts/kmeans_ab.py --root $r; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="checkout whose heat_tpu_torch is timed")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))  # the timed package
    import torch

    if not torch.cuda.is_available():
        print("kmeans_ab: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")  # this checkout's
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import heat_tpu_torch as ht

    if Path(ht.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {ht.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    ht.use_device("gpu")
    from heat_tpu_torch.ops import _build

    _build.load()  # built here, not inside the first timed fit
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    means = torch.rand((cs.K, cs.D), generator=torch.Generator().manual_seed(7)) * 40.0 - 20.0
    ms, fits = {}, {}
    for dtype, label, rtol in ((ht.float32, "float32", 1e-4), (ht.bfloat16, "bfloat16", 2.0**-7)):
        x = ht.utils.data.create_clusters(cs.N_MAIN, cs.D, cs.K, means.numpy(), cluster_std=1.0, device="gpu",
                                          random_state=0, dtype=dtype)
        km, launches, row = cs.main_fit(ht, x, label)
        fits[label] = {key: row[key] for key in ("n_iter", "inertia", "fit_s", "fit_iter_per_s")}
        cs.compare_with_torch_path(ht, x, km, label, atol=2e-2, rtol=rtol)
        rows = cs.time_kernels(x.larray, km._centers, launches, cs.check_at_main_shape(x.larray, km._centers, label))
        ms[label] = {row["name"]: row["ms"] for row in rows}
        del x, km
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "root": str(root), "shape": {"n": cs.N_MAIN, "d": cs.D, "k": cs.K},
                      "ms": ms, "fits": fits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
