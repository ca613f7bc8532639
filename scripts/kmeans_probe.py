#!/usr/bin/env python3
"""Where the KMeans kernels' time goes: variants of their distance pass and
launch, timed in turns against the kept body, on one card.

    python3 scripts/kmeans_probe.py

Builds five variants of ``heat_tpu_torch/ops/csrc/kmeans.cu`` with
``_build.load_variant`` (beside the package's library, which stays as it
is), by text substitutions in a copy under ``build/kmeans_probe/``:

- ``kept``: the source as it is;
- ``no_epilogue``: the clamp-then-argmin over each (row, centre) pair of a
  chunk is replaced by one add and one minimum over each pair of
  accumulators (about 1 instruction an element against the kept ~5-6);
  the products, the quad's reduction and the stores stay;
- ``no_products``: the accumulators are zeroed in place of the tensor-core
  products (no wgmma, no mma.sync, no split of x); the epilogue stays;
- ``mma_sync``: ``use_wgmma`` always false, so the products are mma.sync's
  at every k (the kernels' path past wgmma's k);
- ``copies_first``: ``configure`` ranks the launches by row copies in
  flight first and resident warps second (the kept rule is the reverse).

Then, at the main path's shape (n = 1e8, d = 32, k = 64, blobs from
``chip_smoke.em_edge_inputs``), in float32 and bfloat16, holds each variant
that computes the same function (kept, mma_sync, copies_first) against the
plain version on the first 1,000,003 rows (``compare_assign``,
``compare_em``) and prints its launch (``launch_config``), then times
``assign`` of every variant and ``em_stats`` of those three in turns (the
variants in order, then in reverse), by ``chip_smoke.cuda_ms``.  The stubs'
labels are meaningless, so em_stats, whose fold follows the labels, is not
timed on them.  Prints one JSON line: the card (nvidia-smi's name and power
limit), each variant's launches, and its ms by dtype and kernel, in the
order run.  Exits 2 without a card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

_EPILOGUE = """#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt) {
      const int j = 8 * tile[nt] + 2 * t;
      const float2 cj = *reinterpret_cast<const float2*>(cc + j);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = fmaxf(fmaf(-2.f, acc[mt][nt][2 * h], xr[mt][h] + cj.x), 0.f);
          if (v0 < best[mt][h]) {
            best[mt][h] = v0;
            bi[mt][h] = j;
          }
          const float v1 = fmaxf(fmaf(-2.f, acc[mt][nt][2 * h + 1], xr[mt][h] + cj.y), 0.f);
          if (v1 < best[mt][h]) {
            best[mt][h] = v1;
            bi[mt][h] = j + 1;
          }
        }
    }
"""
_PRODUCTS = """    if constexpr (WG)
      products_wgmma<T, DP>(st, smem_u32(cs), c0 >> 6, lane, acc);
    else
      products_mma<T, DP>(st, cs, tile, lane, acc);
"""
# {variant: [(text of kmeans.cu, its replacement), ...]}
VARIANTS = {
    "kept": [],
    "no_epilogue": [(_EPILOGUE, """#pragma unroll
    for (int nt = 0; nt < kChunk; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) best[mt][h] = fminf(best[mt][h], acc[mt][nt][2 * h] + acc[mt][nt][2 * h + 1]);
""")],
    "no_products": [(_PRODUCTS, """#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kChunk; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
""")],
    "mma_sync": [("  return smem_bytes(k, dp, tsize, 4, 1, true, true) <= size_t(max_smem);\n",
                  "  return false;\n")],
    "copies_first": [("(resident > best_resident || (resident == best_resident && flight > best_flight))",
                      "(flight > best_flight || (flight == best_flight && resident > best_resident))")],
}
# the variants that compute what the kept body does
EXACT = ("kept", "mma_sync", "copies_first")
ORDER = list(VARIANTS) + list(VARIANTS)[::-1]


def variant_source(src: str, subs) -> str:
    """``src`` with each (old, new) of ``subs`` replaced; old must occur once."""
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"kmeans.cu holds {src.count(old)} copies of the text to replace:\n{old}")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("kmeans_probe: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from unittest import mock

    from heat_tpu_torch.ops import _build
    from heat_tpu_torch.ops import kmeans_kernels as kk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    out = _build.BUILD_DIR.parent / "kmeans_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "kmeans.cu").read_text()
    paths = {}
    for name, subs in VARIANTS.items():
        paths[name] = out / f"kmeans_{name}.cu"
        paths[name].write_text(variant_source(src, subs))
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(_build.load_variant, paths.values())))
    ms, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        x, c = cs.em_edge_inputs(cs.N_MAIN, cs.K, cs.D, dtype, "blobs", seed=5)
        xs = x[:1_000_003]
        n = xs.shape[0]
        lab_p, d2_p = kk._torch_assign(xs, c)
        sums_p, counts_p = kk._torch_em_stats(xs, c, n)
        launches[dtype] = {}
        for name in EXACT:
            with mock.patch.object(_build, "_lib", libs[name]):
                lab, d2 = kk.fused_assign(xs, c)
                sums, counts = kk.fused_em_stats(xs, c)
                launches[dtype][name] = {kernel: kk.launch_config(cs.K, cs.D, x.dtype, em=em)
                                         for kernel, em in (("assign", False), ("em_stats", True))}
            _, ties, _ = cs.compare_assign(xs, c, lab, d2, lab_p, d2_p)
            cs.compare_em(xs, c, n, sums, counts, lab, sums_p, counts_p, ties)
        ms[dtype] = {name: {"assign": []} for name in VARIANTS}
        for name in EXACT:
            ms[dtype][name]["em_stats"] = []
        for name in ORDER:
            with mock.patch.object(_build, "_lib", libs[name]):
                ms[dtype][name]["assign"].append(cs.cuda_ms(lambda: kk.fused_assign(x, c), 5))
                if name in EXACT:
                    ms[dtype][name]["em_stats"].append(cs.cuda_ms(lambda: kk.fused_em_stats(x, c), 5))
        del x, xs
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "shape": {"n": cs.N_MAIN, "d": cs.D, "k": cs.K}, "order": ORDER,
                      "launches": launches, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
