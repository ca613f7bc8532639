"""chip_smoke.py's host-side parts, on the CPU: the ptxas report it prints
for the bfloat16 tensor-core kernels, the float32 bodies and the KMeans
kernels, what each flash row of its ``kernels`` line says runs each dtype,
the differing share and the float32 criterion of its edge-shape checks (and
why the edges need them: at one row dq and dk are float32 noise), the
KMeans edge shapes and their comparisons (assign's and em_stats') on the
plain versions, the KMeans kernels' bound, how it takes a profiler session
again that recorded no device activity, and its refusal (and
scripts/kmeans_ab.py's) to run without a card."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu_torch.ops import flash_attention as fa
from heat_tpu_torch.ops import kmeans_kernels as kk

REPO = Path(__file__).resolve().parents[1]
FLASH_NAMES = [f"flash_{kind}{k}" for kind in ("", "gqa_", "pos_") for k in ("fwd", "bwd_dq", "bwd_dkv")]

# ptxas -v as nvcc prints it for one source: two instances of the bfloat16
# forward (one spilling), and a float32 kernel that is not one of them
PTXAS_LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63821flash_fwd_bf16_kernelILi128ELb0ENS_7PosMaskEEEvPK13__nv_bfloat16S4_S4_PS2_PfiiifT2_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63821flash_fwd_bf16_kernelILi128ELb0ENS_7PosMaskEEEvPK13__nv_bfloat16S4_S4_PS2_PfiiifT2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 209 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63821flash_bwd_dq_kernelIfLi64ENS_10StaticMaskEEEvPKT_S4_S4_S4_PKfS6_PS2_iifT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63821flash_bwd_dq_kernelIfLi64ENS_10StaticMaskEEEvPKT_S4_S4_S4_PKfS6_PS2_iifT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63821flash_fwd_bf16_kernelILi64ELb1ENS_10StaticMaskEEEvPK13__nv_bfloat16S4_S4_PS2_PfiiifT2_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63821flash_fwd_bf16_kernelILi64ELb1ENS_10StaticMaskEEEvPK13__nv_bfloat16S4_S4_PS2_PfiiifT2_
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
"""


# the same for the bfloat16 backward: a dq instance and a dk/dv instance
PTXAS_BWD_LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63824flash_bwd_dq_bf16_kernelILi64ELb1ENS_10StaticMaskEEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PS2_iiifT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63824flash_bwd_dq_bf16_kernelILi64ELb1ENS_10StaticMaskEEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PS2_iiifT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63825flash_bwd_dkv_bf16_kernelILi128ELb0ENS_7PosMaskEEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PS2_S8_iiifT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63825flash_bwd_dkv_bf16_kernelILi128ELb0ENS_7PosMaskEEEvPK13__nv_bfloat16S4_S4_S4_PKfS6_PS2_S8_iiifT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 243 registers, used 1 barriers
"""

# the same for the float32 backward on the CUDA cores: a dq and a dk/dv instance
PTXAS_F32_LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63823flash_bwd_dq_f32_kernelILi64ELb1ENS_10StaticMaskEEEvPKfS4_S4_S4_S4_S4_PfiiifT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63823flash_bwd_dq_f32_kernelILi64ELb1ENS_10StaticMaskEEEvPKfS4_S4_S4_S4_S4_PfiiifT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63824flash_bwd_dkv_f32_kernelILi128ELb0ENS_7PosMaskEEEvPKfS4_S4_S4_S4_S4_PfS5_iiifT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63824flash_bwd_dkv_f32_kernelILi128ELb0ENS_7PosMaskEEEvPKfS4_S4_S4_S4_S4_PfS5_iiifT1_
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes cumulative stack size
"""


# the float32 forward on the CUDA cores: two instances, and a dq instance
PTXAS_F32_FWD_LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63820flash_fwd_f32_kernelILi64ELb1ENS_10StaticMaskEEEvPKfS4_S4_PfS5_iiifT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63820flash_fwd_f32_kernelILi64ELb1ENS_10StaticMaskEEEvPKfS4_S4_PfS5_iiifT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63823flash_bwd_dq_f32_kernelILi64ELb1ENS_10StaticMaskEEEvPKfS4_S4_S4_S4_S4_PfiiifT1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__3234eb43_18_flash_attention_cu_9c6df63820flash_fwd_f32_kernelILi128ELb0ENS_7PosMaskEEEvPKfS4_S4_PfS5_iiifT1_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 230 registers, used 1 barriers
"""

# nvcc -Xptxas -v for kmeans.cu: em_stats and assign instances (storage
# type, DP, products by wgmma or not), and em_reduce (not a template)
PTXAS_KMEANS_LOG = """== kmeans.cu
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__5cebfc58_9_kmeans_cu_9a3ece1715em_stats_kernelIfLi32ELb1EEEvPKT_PKfliibiPfPi' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__5cebfc58_9_kmeans_cu_9a3ece1715em_stats_kernelIfLi32ELb1EEEvPKT_PKfliibiPfPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 138 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__5cebfc58_9_kmeans_cu_9a3ece1715em_stats_kernelI13__nv_bfloat16Li128ELb0EEEvPKT_PKfliibiPfPi' for 'sm_90a'
    96 bytes stack frame, 100 bytes spill stores, 100 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 96 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__5cebfc58_9_kmeans_cu_9a3ece1713assign_kernelIfLi32ELb1EEEvPKT_PKfliibiPiPf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 148 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__cabd9633_9_kmeans_cu_f5b8f97116em_reduce_kernelEPKfPKiiiiPfS4_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ptxas_report_reads_each_bf16_forward_instance(chip_smoke):
    assert chip_smoke.ptxas_report(PTXAS_LOG, "flash_fwd_bf16_kernel") == [
        {"D": 128, "vec": False, "mask": "PosMask", "spill_stores": 0, "spill_loads": 0, "registers": 209},
        {"D": 64, "vec": True, "mask": "StaticMask", "spill_stores": 12, "spill_loads": 4, "registers": 128},
    ]
    assert chip_smoke.ptxas_report("", "flash_fwd_bf16_kernel") == []  # a library loaded from the build cache


def test_ptxas_report_reads_each_bf16_backward_instance(chip_smoke):
    """Each backward template's instances, and none of the other's, for
    the bfloat16 bodies and for the float32 ones (the sibling map
    F32_KERNELS, whose ptxas lines chip_smoke.py prints beside them)."""
    assert chip_smoke.ptxas_report(PTXAS_BWD_LOG, "flash_bwd_dq_bf16_kernel") == [
        {"D": 64, "vec": True, "mask": "StaticMask", "spill_stores": 0, "spill_loads": 0, "registers": 160}]
    assert chip_smoke.ptxas_report(PTXAS_BWD_LOG, "flash_bwd_dkv_bf16_kernel") == [
        {"D": 128, "vec": False, "mask": "PosMask", "spill_stores": 0, "spill_loads": 0, "registers": 243}]
    assert chip_smoke.ptxas_report(PTXAS_LOG, "flash_bwd_dq_bf16_kernel") == []  # the old float32 dq is not one
    assert set(chip_smoke.TC_KERNELS) == {"flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                                          "flash_bwd_dkv_bf16_kernel"}
    assert all((REPO / path).is_file() for path in chip_smoke.TC_KERNELS.values())
    # the float32 backward
    assert chip_smoke.ptxas_report(PTXAS_F32_LOG, "flash_bwd_dq_f32_kernel") == [
        {"D": 64, "vec": True, "mask": "StaticMask", "spill_stores": 0, "spill_loads": 0, "registers": 154}]
    assert chip_smoke.ptxas_report(PTXAS_F32_LOG, "flash_bwd_dkv_f32_kernel") == [
        {"D": 128, "vec": False, "mask": "PosMask", "spill_stores": 8, "spill_loads": 8, "registers": 255}]
    assert chip_smoke.ptxas_report(PTXAS_F32_LOG, "flash_bwd_dq_bf16_kernel") == []
    assert chip_smoke.ptxas_report(PTXAS_BWD_LOG, "flash_bwd_dq_f32_kernel") == []
    assert set(chip_smoke.F32_KERNELS) == {"flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel",
                                           "flash_bwd_dkv_f32_kernel"}
    assert all((REPO / path).is_file() for path in chip_smoke.F32_KERNELS.values())
    source = (REPO / chip_smoke.F32_SOURCE).read_text()
    assert all(f"{name}(" in source for name in chip_smoke.F32_KERNELS)


def test_ptxas_report_reads_each_f32_forward_instance(chip_smoke):
    """The float32 forward's instances (D, 16-byte loads, mask), and none of
    the float32 dq's or the bfloat16 forward's."""
    assert chip_smoke.ptxas_report(PTXAS_F32_FWD_LOG, "flash_fwd_f32_kernel") == [
        {"D": 64, "vec": True, "mask": "StaticMask", "spill_stores": 0, "spill_loads": 0, "registers": 168},
        {"D": 128, "vec": False, "mask": "PosMask", "spill_stores": 0, "spill_loads": 0, "registers": 230}]
    assert chip_smoke.ptxas_report(PTXAS_F32_FWD_LOG, "flash_bwd_dq_f32_kernel") == [
        {"D": 64, "vec": True, "mask": "StaticMask", "spill_stores": 0, "spill_loads": 0, "registers": 154}]
    assert chip_smoke.ptxas_report(PTXAS_F32_FWD_LOG, "flash_fwd_bf16_kernel") == []
    assert chip_smoke.ptxas_report(PTXAS_LOG, "flash_fwd_f32_kernel") == []


def test_kmeans_ptxas_report_reads_each_instance(chip_smoke):
    """kmeans_ptxas_report: each instance's storage type, DP and products'
    instruction (wgmma or mma.sync) from the mangled name; em_reduce_kernel,
    not a template, with none; a kernel's report holds its own instances
    only."""
    log = PTXAS_KMEANS_LOG
    assert chip_smoke.kmeans_ptxas_report(log, "em_stats_kernel") == [
        {"dtype": "float32", "DP": 32, "products": "wgmma", "spill_stores": 0, "spill_loads": 0, "registers": 138},
        {"dtype": "bfloat16", "DP": 128, "products": "mma.sync", "spill_stores": 100, "spill_loads": 100,
         "registers": 255}]
    assert chip_smoke.kmeans_ptxas_report(log, "assign_kernel") == [
        {"dtype": "float32", "DP": 32, "products": "wgmma", "spill_stores": 0, "spill_loads": 0, "registers": 148}]
    assert chip_smoke.kmeans_ptxas_report(log, "em_reduce_kernel") == [
        {"spill_stores": 0, "spill_loads": 0, "registers": 32}]
    assert chip_smoke.kmeans_ptxas_report(PTXAS_F32_LOG, "em_stats_kernel") == []
    assert chip_smoke.kmeans_ptxas_report("", "assign_kernel") == []  # a library loaded from the build cache
    assert set(chip_smoke.KMEANS_KERNELS) == {"assign_kernel", "em_stats_kernel", "em_reduce_kernel"}
    source = (REPO / chip_smoke.KMEANS_SOURCE).read_text()
    assert all(f"{name}(" in source for name in chip_smoke.KMEANS_KERNELS)


@pytest.mark.parametrize("name", FLASH_NAMES)
def test_flash_rows_name_each_dtypes_body(chip_smoke, name):
    """Every bfloat16 launch runs on the tensor cores, the forward from
    flash_fwd_tc.cuh, dq and dk/dv from flash_bwd_tc.cuh; float32 on the
    CUDA cores, all three from flash_f32.cuh; each named body is defined in
    its source."""
    cores, sources = chip_smoke.flash_cores(name), chip_smoke.flash_sources(name)
    bodies = chip_smoke.flash_bodies(name)
    fwd = name.endswith("_fwd")
    kind = "fwd" if fwd else "bwd_dq" if name.endswith("_dq") else "bwd_dkv"
    assert cores == {"float32": "CUDA cores", "bfloat16": "mma.sync tensor cores"}
    assert sources["float32"] == "heat_tpu_torch/ops/csrc/flash_f32.cuh"
    assert sources["bfloat16"] == ("heat_tpu_torch/ops/csrc/flash_fwd_tc.cuh" if fwd else
                                   "heat_tpu_torch/ops/csrc/flash_bwd_tc.cuh")
    assert bodies == {"float32": f"flash_{kind}_f32_kernel", "bfloat16": f"flash_{kind}_bf16_kernel"}
    assert all((REPO / path).is_file() for path in sources.values())
    for dtype, body in bodies.items():
        assert f"{body}(" in (REPO / sources[dtype]).read_text()


def test_forward_edge_checks_stay_inside_the_kernels_limits(chip_smoke):
    """The forward-only edge shapes: valid (query rows a multiple of the
    K/V rows, 1 <= d <= 128) and each under the 129 rows from which the
    three-kernel checks start."""
    for bhq, bhk, S, d, causal in chip_smoke.FWD_EDGE_CHECKS + chip_smoke.GQA_FWD_EDGE_CHECKS:
        assert bhq % bhk == 0 and 1 <= d <= 128 and 1 <= S < 129 and isinstance(causal, bool)
    assert {d for *_, d, _ in chip_smoke.FWD_EDGE_CHECKS + chip_smoke.GQA_FWD_EDGE_CHECKS} >= {8, 33, 100}


def test_wide_checks_cover_every_wide_head_dim(chip_smoke):
    """The wide route's checks: each of WIDE_DS through the multi-head,
    grouped and positions wrappers (valid shapes past WIDE_D, the d512
    timings' shapes among them), and its edges past WIDE_D under 129 rows;
    every d up to WIDE_D keeps the 1% bfloat16 share, and past it the share
    grows as sqrt(d / WIDE_D)."""
    cs = chip_smoke
    for checks in (cs.FLASH_CHECKS, cs.GQA_CHECKS):
        assert {c[3] for c in checks if c[3] > cs.WIDE_D} == set(cs.WIDE_DS)
        assert all(bhq % bhk == 0 for bhq, bhk, *_ in checks)
    assert {c[3] for c in cs.POS_CHECKS if c[3] > cs.WIDE_D} == set(cs.WIDE_DS)
    assert cs.FLASH_D512 + (True,) in cs.FLASH_CHECKS and cs.GQA_D512 + (True,) in cs.GQA_CHECKS
    for bhq, bhk, S, d, causal in cs.WIDE_EDGE_CHECKS:
        assert bhq % bhk == 0 and d > cs.WIDE_D and 1 <= S < 129 and isinstance(causal, bool)
    assert cs.bf16_share_limit(1) == cs.bf16_share_limit(cs.WIDE_D) == cs.BF16_DIFF_SHARE == 0.01
    assert cs.bf16_share_limit(4 * cs.WIDE_D) == 2 * cs.BF16_DIFF_SHARE
    assert [round(cs.bf16_share_limit(d), 4) for d in cs.WIDE_DS] == [0.01, 0.0112, 0.0141, 0.021]
    assert cs.LM_D512["embed_dim"] // cs.LM_D512["num_heads"] == 512


def test_sdpa_backend_names_the_served_backend(chip_smoke):
    """Which backend of scaled_dot_product_attention ran, from its kernels' names."""
    name = chip_smoke.sdpa_backend
    assert name(["fmha_cutlassF_f32_aligned_32x128_gmem_sm80(PyTorchMemEffAttention::AttentionKernel"]) == "efficient"
    assert name(["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits"]) == "flash"
    assert name(["cudnn_generated_fort_native_sdpa_sm90_flash_fprop"]) == "cudnn"
    assert name(["sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128"]) == "math"


def test_edge_share_counts_only_elements_above_the_row_floor(chip_smoke):
    """_share_above_floor: the share of differing elements among those whose
    plain value reaches ROW_FLOOR of the tensor's scale (or of 1)."""
    want = torch.tensor([[1.0, -0.5, 1e-3, 0.25], [2e-3, 0.0, 1e-4, 4.0]])
    assert chip_smoke._share_above_floor(want, want) == 0.0
    got = want.clone()
    got[0, 2] += 1e-4  # below the floor (2^-7 of 4): not counted
    assert chip_smoke._share_above_floor(got, want) == 0.0
    got[1, 3] = 4.03125  # one of the 4 elements above the floor
    assert chip_smoke._share_above_floor(got, want) == 0.25
    noise = torch.full((3, 8), 1e-7)  # every element below the floor: nothing to count
    assert chip_smoke._share_above_floor(-noise, noise) == 0.0


def test_one_row_backward_is_float32_noise_whose_bits_follow_the_sum_order(chip_smoke):
    """At S = 1 each row has one key: P = 1 and O = V, so dP - dd = dO.V -
    dO.O is 0 but for the rounding of two float32 sums, and dq = dS K and
    dk = dS^T Q hold only that noise.  On the plain versions: dq and dk lie
    far below ROW_FLOOR of the inputs' unit scale, dv = dO exactly, and
    taking dd's sum in another order (exactly rounded against sequential)
    gives other bits in many elements, the same noise that a kernel's
    tensor-core sums give: so the edge checks count only elements above the
    row floor, and nothing there is a kernel's fault."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((64, 1, 64), dtype=np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    scale = 64**-0.5
    out, lse = fa._torch_flash_fwd(q, k, v, True, scale)
    assert torch.equal(out, v)
    prod = do.double() * out.double()
    dd_exact = prod.sum(-1).float()
    dd_seq = torch.zeros(prod.shape[:-1])
    for i in range(prod.shape[-1]):  # left to right in float32
        dd_seq = dd_seq + prod[..., i].float()
    assert not torch.equal(dd_exact, dd_seq)
    grads = [(fa._torch_flash_bwd_dq(q, k, v, do, lse, dd, True, scale),
              *fa._torch_flash_bwd_dkv(q, k, v, do, lse, dd, True, scale)) for dd in (dd_exact, dd_seq)]
    for dq, dk, dv in grads:
        assert float(dq.float().abs().max()) < 1e-3 * chip_smoke.ROW_FLOOR
        assert float(dk.float().abs().max()) < 1e-3 * chip_smoke.ROW_FLOOR
        assert torch.equal(dv, do)
    (dq_a, dk_a, _), (dq_b, dk_b, _) = grads
    for a, b in ((dq_a, dq_b), (dk_a, dk_b)):
        share = float((a != b).float().mean())
        assert share > chip_smoke.BF16_DIFF_SHARE  # the plain share counts noise
        assert chip_smoke._share_above_floor(a, b) == 0.0
        assert chip_smoke._row_err(a, b) < 1e-3  # held by the row error instead


def test_edge_criterion_passes_float32_noise_and_fails_a_bfloat16_step(chip_smoke):
    """The float32 edge criterion (_edge_err, _edge_ok) on the plain
    versions at S = 1, 8 query heads to a K/V head, d = 128, where every
    row of dq and dk is float32 noise of a cancelled sum: dd summed in two
    orders (exactly rounded and left to right) gives other bits, noise
    above FLASH_TOL's 2e-4 of the row floor (what _row_err allows there)
    and within EDGE_F32_ATOL, so the criterion passes both; an error of one
    bfloat16 step of a value at the floor (2^-14) in a row below it fails,
    and so does one bfloat16 step of the largest element of a row that
    reaches the floor."""
    rng = np.random.default_rng(0)
    q, do = (torch.from_numpy(rng.standard_normal((32, 1, 128), dtype=np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((4, 1, 128), dtype=np.float32)) for _ in range(2))
    scale = 128**-0.5
    out, lse = fa._torch_flash_gqa_fwd(q, k, v, True, scale)
    prod = do.double() * out.double()
    dd_exact = prod.sum(-1).float()
    dd_seq = torch.zeros(prod.shape[:-1])
    for i in range(prod.shape[-1]):  # left to right in float32
        dd_seq = dd_seq + prod[..., i].float()
    assert not torch.equal(dd_exact, dd_seq)
    grads = [(fa._torch_flash_gqa_bwd_dq(q, k, v, do, lse, dd, True, scale),
              *fa._torch_flash_gqa_bwd_dkv(q, k, v, do, lse, dd, True, scale)) for dd in (dd_exact, dd_seq)]
    floor = chip_smoke.ROW_FLOOR
    noisy = 0.0
    for key, a, b in zip(("dq", "dk", "dv"), *grads):
        above, below = chip_smoke._edge_err(a, b)
        assert chip_smoke._edge_ok((above, below))
        if key == "dv":  # the group's dO summed: dd takes no part
            assert torch.equal(a, b)
        else:  # no row reaches the floor: all noise
            assert above == 0.0
            noisy = max(noisy, below)
    assert noisy > chip_smoke.FLASH_TOL["float32"]["grad"] * floor  # _row_err would refuse this noise
    assert chip_smoke._row_err(grads[0][1], grads[1][1]) > chip_smoke.FLASH_TOL["float32"]["grad"]
    bf16_step = floor * 2.0**-7
    assert bf16_step > chip_smoke.EDGE_F32_ATOL
    dq = grads[0][0]
    off = dq.clone()
    off[3, 0, 7] += bf16_step
    assert not chip_smoke._edge_ok(chip_smoke._edge_err(off, dq))
    # a row that reaches the floor: dv; its largest element one bfloat16 step off
    dv = grads[0][2]
    assert float(dv.abs().max()) >= floor
    i = int(dv.abs().flatten().argmax())
    off = dv.clone().flatten()
    off[i] += float(torch.tensor(float(off[i])).to(torch.bfloat16).float().abs()) * 2.0**-8
    assert not chip_smoke._edge_ok(chip_smoke._edge_err(off.view_as(dv), dv))


def test_edge_err_splits_rows_at_the_floor(chip_smoke):
    """_edge_err: the row error over rows reaching ROW_FLOOR of the
    tensor's scale (or of 1), the absolute error over the rows below it."""
    want = torch.tensor([[1.0, -0.5], [2e-3, 1e-3], [0.0, 4.0]])
    assert chip_smoke._edge_err(want, want) == (0.0, 0.0)
    got = want.clone()
    got[1, 0] += 1e-5  # below the floor (2^-7 of 4): absolute
    got[2, 1] += 4e-4  # above it: 1e-4 of the row's largest value
    above, below = chip_smoke._edge_err(got, want)
    assert below == pytest.approx(1e-5, rel=1e-3) and above == pytest.approx(1e-4, rel=1e-3)
    assert chip_smoke._edge_ok((above, below))
    assert not chip_smoke._edge_ok((above, 2 * chip_smoke.EDGE_F32_ATOL))
    assert not chip_smoke._edge_ok((3e-4, below))


def test_chip_smoke_without_cuda_exits_2_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2
    assert '"ok"' not in out.stdout


def test_kmeans_ab_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: kmeans_ab.py would run")
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "kmeans_ab.py")], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2
    assert '"ms"' not in out.stdout


def _kmeans_probe():
    spec = importlib.util.spec_from_file_location("kmeans_probe", REPO / "scripts" / "kmeans_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kmeans_probe_variants_apply_to_the_kernel_source():
    """scripts/kmeans_probe.py's variants each find their text once in
    kmeans.cu: no_epilogue drops the clamp-then-argmin and keeps the
    products, no_products drops both products calls and keeps the
    epilogue, mma_sync turns wgmma off, copies_first swaps configure's
    ranking; each variant is timed once each way; a text the source does
    not hold is refused."""
    probe = _kmeans_probe()
    src = (REPO / "heat_tpu_torch" / "ops" / "csrc" / "kmeans.cu").read_text()
    out = {name: probe.variant_source(src, subs) for name, subs in probe.VARIANTS.items()}
    assert out["kept"] == src
    assert "bi[mt][h] = j + 1;" not in out["no_epilogue"] and "products_wgmma<T, DP>(st," in out["no_epilogue"]
    assert "products_wgmma<T, DP>(st," not in out["no_products"] and "products_mma<T, DP>(st," not in out[
        "no_products"] and "bi[mt][h] = j + 1;" in out["no_products"]
    assert "return false;" in out["mma_sync"] and "flight > best_flight ||" in out["copies_first"]
    assert set(probe.EXACT) == {"kept", "mma_sync", "copies_first"}
    assert sorted(probe.ORDER) == sorted(2 * list(probe.VARIANTS)) and probe.ORDER == probe.ORDER[::-1]
    with pytest.raises(RuntimeError, match="0 copies"):
        probe.variant_source(src, [("no such text", "")])


def test_kmeans_residency_counter_brackets_both_kernels():
    """kmeans.cu's residency counter is the first statement and the last of
    assign_kernel and em_stats_kernel, entering and leaving."""
    src = (REPO / "heat_tpu_torch" / "ops" / "csrc" / "kmeans.cu").read_text()
    for kernel in ("assign_kernel(", "em_stats_kernel("):
        body = src[src.index(kernel):]
        body = body[body.index("{") + 1:body.index("\n}\n")]
        assert body.lstrip().startswith("count_resident(true);")
        assert body.rstrip().endswith("count_resident(false);")


def test_kmeans_probe_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: kmeans_probe.py would run")
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "kmeans_probe.py")], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2
    assert '"ms"' not in out.stdout


def test_em_edge_checks_cover_the_kernels_edges(chip_smoke):
    """EM_EDGE_CHECKS, where assign and em_stats are both held: k from 1 to
    past a 64-centre chunk, off the n8 tiles (1, 3, 9, 61, 64, 127, 200,
    300); k past what wgmma's centres hold in shared memory, so mma.sync
    takes the products (300 at d = 32, 64 at d = 128, 127 at d = 100); d of
    1, 8, off and on the 32-, 64- and 128-column tiles (33, 36, 100), up to
    128; the streamed route at d = 129, 200, 256 and 512 and at k one past
    each kernel's cap; n of 0, 1, under one 32-row tile, off a block's
    tiles, and past the rows; both dtypes; rows contiguous by cluster and
    in random order; rows off 16-byte alignment in both dtypes, at d = 32
    where they would otherwise take 16-byte copies; one cluster holding
    DOMINANT_SHARE of 1e6 rows in both dtypes."""
    edges = chip_smoke.EM_EDGE_CHECKS
    assert {k for _, _, k, _, _, _ in edges} >= {1, 3, 9, 61, 64, 127, 200, 300}
    assert {k % 8 for _, _, k, _, _, _ in edges} >= {1, 3, 5, 7}
    assert {d for _, _, _, d, _, _ in edges} >= {1, 8, 33, 36, 64, 100, 128}
    assert {(k, d) for _, _, k, d, dt, _ in edges if dt == "float32"} >= {(300, 32), (64, 128)}
    assert (127, 100, "bfloat16") in {(k, d, dt) for _, _, k, d, dt, _ in edges}
    ns = {n for _, n, _, _, _, _ in edges}
    assert {0, 1} <= ns and any(1 < n < 32 for n in ns) and any(n % 512 for n in ns if n > 512)
    assert any(n > rows for rows, n, *_ in edges)
    assert {dt for *_, dt, _ in edges} == {"float32", "bfloat16"}
    assert {lay.partition("+")[0] for *_, lay in edges} == {"blobs", "shuffled", "dominant"}
    assert {(d, dt) for _, _, _, d, dt, lay in edges if lay.endswith("+offset")} == {
        (32, "float32"), (32, "bfloat16")}
    assert {(rows, dt) for rows, _, _, _, dt, lay in edges if lay == "dominant"} == {
        (1_000_000, "float32"), (1_000_000, "bfloat16")}
    assert chip_smoke.DOMINANT_SHARE >= 0.99
    assert all(d >= 1 and k >= 1 and n >= 0 for _, n, k, d, _, _ in edges)
    # the streamed route: d past the 128-column tiles, and k one centre past
    # each kernel's cap (em_stats 862 and 208, assign 1720 and 416 at d = 32
    # and 128 in float32; em_stats 216 at d = 128 in bfloat16)
    assert {d for _, _, _, d, _, _ in edges} >= {129, 200, 256, 512}
    assert {(k, d, dt) for _, _, k, d, dt, _ in edges} >= {
        (863, 32, "float32"), (1721, 32, "float32"), (209, 128, "float32"), (417, 128, "float32"),
        (217, 128, "bfloat16")}


def test_serving_stream_accepts_64_jobs_and_sheds_the_rest(chip_smoke):
    """The serving phase offers more jobs than its queue holds, as the
    reference's serve scenario does: at least 64 are accepted, the rest
    are shed, and its KMeans jobs' width and k are among the edges."""
    from heat_tpu_torch.parallel import serve_world as sw

    jobs = sw.job_stream(chip_smoke.SERVE_JOBS, **chip_smoke.SERVE_SIZES)
    accepted = sw.queue_bound(len(jobs))
    assert 64 <= accepted < len(jobs)
    assert {j["kind"] for j in jobs[:accepted]} == {"kmeans", "matmul", "solve", "nn_forward"}
    assert {j["tenant"] for j in jobs} == set(sw.TENANTS) and {j["priority"] for j in jobs} == {0, 1, 2}
    assert (2, 2, "float32") in {(k, d, dt) for _, _, k, d, dt, _ in chip_smoke.EM_EDGE_CHECKS}


@pytest.mark.parametrize("layout", ["blobs", "shuffled", "dominant"])
def test_em_edge_inputs_lay_out_the_rows(chip_smoke, layout):
    """em_edge_inputs on the CPU: the shapes and dtype asked for; blobs
    keep each cluster's rows contiguous (labels ascend), shuffled rows do
    not (the labels change between neighbouring rows only where blobs
    overlap, against about every row), and the dominant layout puts
    DOMINANT_SHARE of the rows first, in cluster 0."""
    x, c = chip_smoke.em_edge_inputs(4000, 8, 5, "float32", layout, seed=3, device="cpu")
    assert x.shape == (4000, 5) and c.shape == (8, 5) and x.dtype == c.dtype == torch.float32
    lab, _ = kk._torch_assign(x, c)
    steps = int((lab[1:] != lab[:-1]).sum())
    if layout == "blobs":
        assert steps < 200
    elif layout == "shuffled":
        assert steps > 1000
    else:
        big = int(4000 * chip_smoke.DOMINANT_SHARE)
        assert bool((lab[:big] == 0).all())
    xb, _ = chip_smoke.em_edge_inputs(100, 3, 33, "bfloat16", layout, seed=3, device="cpu")
    assert xb.dtype == torch.bfloat16 and xb.shape == (100, 33)


@pytest.mark.parametrize("rows,n,k,d,dtype,layout", [(3000, 2999, 1, 32, "float32", "blobs"),
                                                      (3000, 1000, 61, 33, "float32", "shuffled"),
                                                      (1000, 5000, 3, 100, "bfloat16", "blobs"),
                                                      (5000, 5000, 6, 8, "float32", "dominant"),
                                                      (700, 0, 4, 1, "float32", "shuffled")])
def test_compare_em_holds_the_plain_version_and_refuses_a_wrong_sum(chip_smoke, rows, n, k, d, dtype, layout):
    """compare_em, as check_em_edges calls it, on the plain versions at
    small edge shapes: the plain em_stats against itself and the float64
    scatter of the plain labels passes; a count off by one, or a sum off by
    one part in 1e4 of its magnitude, fails."""
    x, c = chip_smoke.em_edge_inputs(rows, k, d, dtype, layout, seed=rows + k, device="cpu")
    sums, counts = kk._torch_em_stats(x, c, min(n, rows))
    lab, _ = kk._torch_assign(x, c)
    assert float(counts.sum()) == min(n, rows)
    err, _ = chip_smoke.compare_em(x, c, n, sums, counts, lab, sums, counts, 0)  # raises past SUM_RTOL
    assert err == 0.0
    if not n:
        return
    moved = counts.clone()
    moved[int(lab[0])] += 1
    with pytest.raises(RuntimeError, match="counts"):
        chip_smoke.compare_em(x, c, n, sums, moved, lab, sums, counts, 0)
    off = sums.clone()
    j = int(lab[0])
    off[j, 0] += 1e-4 * float(x[:n].float()[lab[:n] == j, 0].abs().sum()) + 1e-2
    with pytest.raises(RuntimeError, match="sums"):
        chip_smoke.compare_em(x, c, n, off, counts, lab, sums, counts, 0)


def test_em_edge_inputs_offset_view_is_off_alignment(chip_smoke):
    """A "+offset" layout: the same rows as the plain layout, contiguous,
    starting one element into their buffer, so off 16-byte alignment."""
    for dtype in ("float32", "bfloat16"):
        x, c = chip_smoke.em_edge_inputs(300, 5, 32, dtype, "shuffled", seed=4, device="cpu")
        xo, co = chip_smoke.em_edge_inputs(300, 5, 32, dtype, "shuffled+offset", seed=4, device="cpu")
        assert torch.equal(x, xo) and torch.equal(c, co)
        assert xo.is_contiguous() and xo.data_ptr() % 16 != 0


def test_kmeans_bound_is_the_bytes_at_the_main_shape(chip_smoke):
    """bound() at the main path's n = 1e8, d = 32, k = 64: the bytes moved
    once at 3.35 TB/s exceed the split-TF32 products at 495 TFLOP/s (three
    in float32, two in bfloat16), so all four kernels are bound by bytes:
    assign 4.06 / 2.15 ms, em_stats 3.82 / 1.91 ms (float32 / bfloat16).
    The same work as float32 FFMAs (ffma_bound, the bound before the
    tensor cores): 6.11 and 6.16 ms."""
    want = {(False, 4): 4.06, (False, 2): 2.15, (True, 4): 3.82, (True, 2): 1.91}
    for (em, itemsize), ms in want.items():
        b_ms, b_by = chip_smoke.bound(chip_smoke.N_MAIN, itemsize, em)
        assert round(b_ms, 2) == ms and b_by == "bytes"
        assert round(chip_smoke.ffma_bound(chip_smoke.N_MAIN, itemsize, em), 2) == (6.16 if em else 6.11)
        products = (3 if itemsize == 4 else 2) * 2 * chip_smoke.N_MAIN * chip_smoke.K * chip_smoke.D
        assert products / chip_smoke.PEAK_TF32_FLOPS * 1e3 < b_ms


@pytest.mark.parametrize("rows,k,d,dtype", [(3000, 64, 32, "float32"), (2000, 9, 36, "float32"),
                                            (1000, 61, 100, "bfloat16"), (500, 1, 8, "float32")])
def test_compare_assign_passes_near_ties_and_refuses_far_labels(chip_smoke, rows, k, d, dtype):
    """compare_assign, as check_em_edges calls it, on the plain version at
    small edge shapes: against itself it passes; a d2 off by 1e-4 of |x|^2
    + |c|^2 fails, and so does a label moved to a centre that is not a near
    tie."""
    x, c = chip_smoke.em_edge_inputs(rows, k, d, dtype, "shuffled", seed=rows + k, device="cpu")
    lab, d2 = kk._torch_assign(x, c)
    assert chip_smoke.compare_assign(x, c, lab, d2, lab, d2) == (0, 0, 0.0)
    scale = float(x[0].float().square().sum() + c[int(lab[0])].square().sum())
    off = d2.clone()
    off[0] += 1e-4 * scale
    with pytest.raises(RuntimeError, match="d2 row"):
        chip_smoke.compare_assign(x, c, lab, off, lab, d2)
    if k > 1:
        moved = lab.clone()
        moved[0] = (int(lab[0]) + 1) % k
        with pytest.raises(RuntimeError, match="near tie"):
            chip_smoke.compare_assign(x, c, moved, d2, lab, d2)


def test_matmul_split_table_is_the_reference_table(chip_smoke):
    """The two-rank phase holds each matmul split against MATMUL_SPLITS: the
    reference's ``_matmul_result_split`` for the nine cases and its 1-D rule
    for the vector products."""
    import heat_tpu

    from heat_tpu.linalg.basics import _matmul_result_split

    for sa in (None, 0, 1):
        for sb in (None, 0, 1):
            assert chip_smoke.MATMUL_SPLITS[f"{sa},{sb}"] == _matmul_result_split(sa, sb, 2)
    v, m = heat_tpu.ones(8, split=0), heat_tpu.ones((8, 8), split=1)
    assert chip_smoke.MATMUL_SPLITS["vector @ matrix 0,1"] == heat_tpu.matmul(v, m).split
    assert chip_smoke.MATMUL_SPLITS["matrix @ vector 1,0"] == heat_tpu.matmul(m, v).split


def test_matmul_check_measures_against_the_largest_entry(chip_smoke):
    want = torch.tensor([[4.0, -2.0], [1.0, 0.5]])
    assert chip_smoke.matmul_check(want, want) == 0.0
    assert chip_smoke.matmul_check(want + torch.tensor([[0.0, 4e-5], [0.0, 0.0]]), want) == pytest.approx(1e-5, rel=1e-2)
    # TF32 products (10 mantissa bits) miss MATMUL_RTOL by two orders
    tf32 = want * (1 + 2.0**-11)
    assert chip_smoke.matmul_check(tf32, want) > 10 * chip_smoke.MATMUL_RTOL


def test_summa_multicard_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: summa_multicard.py would run")
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "summa_multicard.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and '"ok"' not in out.stdout


def test_qr_flops_at_config_1(chip_smoke):
    """The counts the config-1 phase divides by: the standard 4mn^2 - 4n^3/3
    (~262 GFLOP at 1e6 x 256) and CholeskyQR2's four executed m.n^2
    products at world size 1 (~524 GFLOP); mode 'r' three, the SVD five;
    on four ranks TSQR's merge adds one product to each route with a Q."""
    m, n = chip_smoke.QR_SHAPE
    f = chip_smoke.qr_flops(m, n)
    assert (m, n) == (1_000_000, 256)
    assert f["standard"] == pytest.approx(262.12e9, rel=1e-4)
    assert f["cholqr2"] == 4 * 2.0 * m * n * n == pytest.approx(524.288e9)
    assert f["cholqr2_r"] == 3 * 2.0 * m * n * n and f["svd"] == 5 * 2.0 * m * n * n
    assert f["standard_r"] == pytest.approx(f["standard"] / 2)
    assert f["householder"] == f["standard"]
    f4 = chip_smoke.qr_flops(m, n, world=4)
    assert f4["cholqr2"] == 5 * 2.0 * m * n * n and f4["svd"] == 6 * 2.0 * m * n * n
    assert f4["cholqr2_r"] == f["cholqr2_r"] and f4["householder"] == f["standard"] + 2.0 * m * n * n


def test_qr_errors_hold_a_factorization_and_refuse_a_wrong_one(chip_smoke):
    """The float64 checks of the config-1 phase, over blocks of rows: a
    float32 QR passes QR_TOL; a Q whose columns lean on each other by one
    part in 1e3 (as TF32 Grams leave them) fails the orthogonality; an
    SVD's U, S, V^T take the same measure."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5000, 16, generator=g)
    q, r = torch.linalg.qr(a)
    errs = chip_smoke.qr_errors(a, q, r, rows=1024)
    assert errs["rel_err"] < 1e-6 and errs["orth_err"] < 1e-5 and errs["tril_max"] == 0.0
    bad = chip_smoke.qr_errors(a, q + 1e-3 * q.roll(1, dims=1), r, rows=1024)
    assert bad["orth_err"] > chip_smoke.QR_TOL
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    errs = chip_smoke.qr_errors(a, u, vh, s=s, rows=999)
    assert errs["rel_err"] < 1e-6 and errs["orth_err"] < 1e-5 and "tril_max" not in errs


def test_align_signs_recovers_a_flipped_factorization(chip_smoke):
    g = torch.Generator().manual_seed(1)
    a = torch.randn(300, 8, generator=g)
    q, r = torch.linalg.qr(a)
    flip = torch.tensor([1.0, -1, -1, 1, 1, -1, 1, -1])
    d = chip_smoke.align_signs(flip[:, None] * r, r)
    assert torch.equal(d, flip)
    assert chip_smoke.rel_max(q * flip * d, q) == 0.0
    assert chip_smoke.rel_max(d[:, None] * (flip[:, None] * r), r) == 0.0


def test_cdist_bound_is_the_result_written_once(chip_smoke):
    """32768^2 float32 distances of 32 features: the 4 GiB result at 3.35
    TB/s (1.28 ms) outlasts 2nmd operations at 67 TFLOP/s (1.03 ms)."""
    n, d = chip_smoke.CDIST_SHAPE
    ms, by = chip_smoke.cdist_bound_ms(n, n, d)
    assert by == "bytes" and ms == pytest.approx(4.0 * (n * n + 2 * n * d) / 3.35e12 * 1e3)
    assert ms == pytest.approx(1.28, rel=1e-2)
    assert 2.0 * n * n * d / 67e12 * 1e3 == pytest.approx(1.03, rel=1e-2)
    assert chip_smoke.cdist_bound_ms(4096, 4096, 128)[1] == "operations"


def _tf32(t):
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("quadratic_expansion", [False, True])
def test_rbf_check_passes_float32_and_refuses_tf32_and_bfloat16(chip_smoke, quadratic_expansion):
    """The cdist phase's rbf check (RBF_SIGMA, CDIST_RTOL of each entry) at
    its width: the port's float32 rbf of randn rows passes by either form;
    the kernel of the same rows rounded to TF32 (the expansion's GEMM as
    TF32 takes it) or to bfloat16, then computed in float64, fails."""
    import heat_tpu_torch as htt

    g = torch.Generator().manual_seed(0)
    d = chip_smoke.CDIST_SHAPE[1]
    assert chip_smoke.RBF_SIGMA == pytest.approx((2.0 * d) ** 0.5)
    x, y = torch.randn(256, d, generator=g), torch.randn(512, d, generator=g)
    want = chip_smoke.rbf_want(torch.cdist(x.double(), y.double()))
    assert 0.05 < float(want.median()) < 0.95
    got = htt.spatial.rbf(htt.array(x, split=0, device="cpu"), htt.array(y, device="cpu"),
                          sigma=chip_smoke.RBF_SIGMA, quadratic_expansion=quadratic_expansion).larray
    assert chip_smoke.within_rtol(got, want)
    for rounded in (_tf32(x), _tf32(y)), (x.bfloat16().float(), y.bfloat16().float()):
        lower = chip_smoke.rbf_want(torch.cdist(rounded[0].double(), rounded[1].double()))
        assert not chip_smoke.within_rtol(lower, want)


def test_tsqr_multicard_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tsqr_multicard.py would run")
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "tsqr_multicard.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and '"ok"' not in out.stdout


def _reference_split(op: str, split: int):
    """The split the JAX package gives the indexing phase's operation ``op``
    on a small array of the phase's rank at ``split``."""
    import warnings

    import heat_tpu

    x = heat_tpu.array(np.arange(13 * 4, dtype=np.float32).reshape(13, 4) - 20, split=split)
    a = heat_tpu.array(np.arange(9 * 9, dtype=np.float32).reshape(9, 9) - 40, split=split)
    m = x[:, 0] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if op in ("X[m] = 0", "X[idx] = Y", "A[A < 0] = 0"):
            target = a if op.startswith("A") else x
            key = {"X[m] = 0": m, "X[idx] = Y": [1, 5], "A[A < 0] = 0": a < 0}[op]
            target[key] = 0
            return target.split
        return {
            "X[idx]": lambda: x[[1, 5, 2]], "X[::2]": lambda: x[::2], "X[::-1]": lambda: x[::-1],
            "X[:, 3]": lambda: x[:, 3], "X[m]": lambda: x[m], "where(X > 0, X, 0)": lambda: heat_tpu.where(x > 0, x, 0),
            "nonzero(m)": lambda: heat_tpu.nonzero(m), "A[:, 100:200]": lambda: a[:, 1:5], "A[5]": lambda: a[5],
            "A[:, ::2]": lambda: a[:, ::2], "A.fill_diagonal(0)": lambda: a.fill_diagonal(0),
            "identity": lambda: heat_tpu.identity(9, split=split), "tri": lambda: heat_tpu.tri(9, split=split),
            "vander": lambda: heat_tpu.vander(heat_tpu.array(np.arange(9, dtype=np.float32), split=split)),
        }[op]().split


def test_index_split_table_is_the_reference_rule(chip_smoke):
    """The indexing phase holds each operation's split against INDEX_SPLITS:
    the JAX package's split of the same operation on a small array."""
    assert len(chip_smoke.INDEX_SPLITS) == 21
    for entry, want in chip_smoke.INDEX_SPLITS.items():
        op, split = entry.rsplit(" @ ", 1)
        assert _reference_split(op, int(split)) == want, entry


def test_index_bytes_bound_at_a_small_shape(chip_smoke):
    """Reads count whole 32-byte sectors, writes their bytes: one float of a
    row is a sector, a 400-byte run at byte 400 touches 13 sectors, X's
    128-byte rows four each; the bound is the sum at the card's rate."""
    assert chip_smoke._sectors(0, 128) == 128 and chip_smoke._sectors(12, 4) == 32
    assert chip_smoke._sectors(30, 4) == 64 and chip_smoke._sectors(400, 400) == 416 and chip_smoke._sectors(0, 0) == 0
    n, d = 10, 32
    assert chip_smoke.index_bytes("X[:, 3]", n, d) == (n * 32, n * 4)
    assert chip_smoke.index_bytes("X[idx]", n, d, k=3) == (3 * 8 + 3 * 128, 3 * 128)
    assert chip_smoke.index_bytes("X[::2]", 11, d) == (6 * 128, 6 * 128)
    assert chip_smoke.index_bytes("X[::-1]", n, d) == (n * 128, n * 128)
    assert chip_smoke.index_bytes("X[m]", n, d, nnz=4) == (n + 4 * 128, 4 * 128)
    assert chip_smoke.index_bytes("X[m] = 0", n, d, nnz=4) == (n, 4 * 128)
    assert chip_smoke.index_bytes("nonzero(m)", n, d, nnz=4) == (n, 16)
    assert chip_smoke.index_bytes("where(X > 0, X, 0)", n, d) == (n * 128, n * 128)
    na = 16384
    assert chip_smoke.index_bytes("A[:, 100:200]", 4, na) == (4 * 416, 4 * 400)
    assert chip_smoke.index_bytes("A[5]", na, na) == (na * 4, na * 4)
    assert chip_smoke.index_bytes("A[:, ::2]", na, na) == (na * na * 4, na * na * 2)
    assert chip_smoke.index_bytes("A[A < 0] = 0", na, na, nnz=7) == (na * na * 4, 28)
    assert chip_smoke.index_bytes("A.fill_diagonal(0)", na, na) == (0, na * 4)
    assert chip_smoke.index_bytes("vander", na, na) == (na * 4, na * na * 4)
    read, write = chip_smoke.index_bytes("X[::-1]", chip_smoke.N_MAIN, chip_smoke.D)
    assert read == write == 12_800_000_000
    assert chip_smoke.index_bound_ms("X[::-1]", chip_smoke.N_MAIN, chip_smoke.D) == pytest.approx(
        25.6e9 / 3.35e12 * 1e3)


class _Session:
    """A stand-in for a ``torch.profiler.profile`` session whose device
    rows are ``rows``."""

    def __init__(self, rows):
        self.rows = rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.rows


def _fake_profiler(monkeypatch, chip_smoke, sessions):
    """Profiler sessions that record ``sessions`` in turn (each a list of
    device row names), and no synchronisation."""
    from types import SimpleNamespace

    rows = iter([[SimpleNamespace(key=k, device_type=torch.autograd.DeviceType.CUDA) for k in names]
                 for names in sessions])
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(next(rows)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


@pytest.mark.parametrize("empty", [0, 1, 4])
def test_profiled_takes_a_session_again_while_it_records_nothing(chip_smoke, monkeypatch, empty):
    """A session that recorded no device activity measured nothing: the
    call runs again under a new session until one records some."""
    _fake_profiler(monkeypatch, chip_smoke, [[]] * empty + [["gemm"], ["late"]])
    calls = []
    assert chip_smoke.launched_kernels(lambda: calls.append(1), "probe") == ["gemm"]
    assert len(calls) == empty + 1


def test_profiled_fails_when_sessions_record_nothing_past_its_wait(chip_smoke, monkeypatch):
    """Past ``wait_s`` a session that recorded nothing fails the run; an
    empty device list is never taken for a measurement."""
    _fake_profiler(monkeypatch, chip_smoke, [[]] * 3)
    with pytest.raises(RuntimeError, match="recorded no device activity"):
        chip_smoke.profiled(lambda: None, "probe", wait_s=0.0)


@pytest.mark.parametrize("teardown", [False, True])
def test_profiled_finalizes_cupti_only_in_the_scripts_own_process(chip_smoke, monkeypatch, teardown):
    """With ``_TEARDOWN_CUPTI`` (set by ``main`` alone) each session runs
    with ``TEARDOWN_CUPTI=1``; the variable is gone after it, so ranks
    spawned later never inherit it."""
    import os

    _fake_profiler(monkeypatch, chip_smoke, [[], ["gemm"]])
    monkeypatch.setattr(chip_smoke, "_TEARDOWN_CUPTI", teardown)
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    seen = []
    chip_smoke.profiled(lambda: seen.append(os.environ.get("TEARDOWN_CUPTI")), "probe")
    assert seen == (["1", "1"] if teardown else [None, None])
    assert "TEARDOWN_CUPTI" not in os.environ


def test_estimators_multicard_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: estimators_multicard.py would run")
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "estimators_multicard.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("perm", [[0, 1, 2], [2, 0, 1]])
def test_agreement_is_the_share_under_the_best_mapping(chip_smoke, perm):
    truth = torch.tensor([0] * 5 + [1] * 5 + [2] * 5)
    labels = torch.tensor(perm)[truth]
    assert chip_smoke._agreement(labels, truth, 3) == 1.0
    labels[0] = labels[5]  # one row in the wrong cluster
    assert chip_smoke._agreement(labels, truth, 3) == 14 / 15


def test_cd64_is_the_port_lasso_on_the_same_gram(chip_smoke):
    """chip_smoke's float64 coordinate descent, the Lasso check's witness,
    gives the port's θ and sweeps from the same Gram."""
    import heat_tpu_torch as htt
    from heat_tpu_torch.regression.lasso import gram

    prev = htt.get_device()
    htt.use_device("cpu")
    try:
        rng = np.random.default_rng(3)
        X = rng.standard_normal((300, 6)).astype(np.float32)
        y = (X @ np.array([1.0, 0, -2, 0, 0.5, 0]) + 0.3).astype(np.float32)
        est = htt.regression.Lasso(lam=0.02, max_iter=50, tol=1e-7).fit(htt.array(X, split=0), htt.array(y, split=0))
        G, b = gram(htt.array(X, split=0), torch.from_numpy(y))
        theta, sweeps = chip_smoke._cd64(G, b, 0.02 * 300, 50, 1e-7)
    finally:
        htt.use_device(prev)
    np.testing.assert_allclose(est.theta.numpy().reshape(-1), theta, rtol=1e-6, atol=1e-7)
    assert sweeps == est.n_iter_


def test_surface_convolve_bound_is_the_operations_at_the_phase_shape(chip_smoke):
    """2nm float32 operations at 67 TFLOP/s: 3.05 ms for 1e8 samples and
    1023 taps, far above the bytes moved (1.2 GB, 0.36 ms)."""
    n, m = chip_smoke.SURF_CONV_N, chip_smoke.SURF_CONV_M
    ms, by = chip_smoke.conv_bound_ms(n, m)
    assert by == "operations"
    assert ms == pytest.approx(2.0 * n * m / chip_smoke.PEAK_FP32 * 1e3)
    assert ms == pytest.approx(3.0537, rel=1e-4)
    tiny_ms, tiny_by = chip_smoke.conv_bound_ms(1000, 1)  # one tap: the bytes bound
    assert tiny_by == "bytes" and tiny_ms == pytest.approx((4 * 1001 + 4 * 1000) / chip_smoke.PEAK_BYTES * 1e3)


def test_surface_sparse_bound_is_the_bytes_moved_once(chip_smoke):
    """Values (4 bytes) and int64 column indices once, the row pointers,
    the dense operand once and the result written once, at 3.35 TB/s."""
    n, r, k = chip_smoke.SURF_SPARSE_N, chip_smoke.SURF_SPARSE_ROW, chip_smoke.SURF_SPARSE_K
    b = chip_smoke.spmm_bytes(n, n * r, k, n)
    assert b == n * r * 12 + (n + 1) * 8 + n * k * 4 * 2
    ms, by = chip_smoke.spmm_bound_ms(n, n * r, k, n)
    assert by == "bytes" and ms == pytest.approx(b / chip_smoke.PEAK_BYTES * 1e3)
    assert chip_smoke.spmm_bytes(2, 3, 1, 4) == 3 * 12 + 3 * 8 + 4 * 4 + 2 * 4


def test_surface_scratch_dir_is_removed_even_when_a_check_fails(chip_smoke):
    with pytest.raises(RuntimeError):
        with chip_smoke.scratch_dir() as d:
            open(Path(d) / "x.npy", "wb").write(b"1")
            chip_smoke.fail("a check")
    assert not Path(d).exists()
    with chip_smoke.scratch_dir() as d2:
        assert Path(d2).is_dir()
    assert not Path(d2).exists()


def test_surface_prints_the_h5py_line_only_without_h5py(chip_smoke, monkeypatch):
    try:
        import h5py  # noqa: F401

        assert chip_smoke.hdf5_missing() is None
    except ImportError:
        pass
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises ImportError
    assert chip_smoke.hdf5_missing() == {"hdf5": "h5py not installed"}


def test_no_port_file_or_chip_smoke_imports_jax_or_heat_tpu():
    """Beyond the import statements (tests/test_torch_core.py): no port
    source or chip_smoke.py names jax or heat_tpu in an import by string,
    and the slice's modules run with jax and heat_tpu blocked."""
    import re

    pattern = re.compile(r"""import_module\(\s*['"](jax|heat_tpu)\b|__import__\(\s*['"](jax|heat_tpu)\b""")
    for f in sorted((REPO / "heat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(f.read_text()), f
    code = (
        "import sys, tempfile, os\n"
        "for m in ('jax', 'jaxlib', 'heat_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import heat_tpu_torch as ht\n"
        "ht.use_device('cpu')\n"
        "x = ht.array(np.arange(12, dtype=np.float32).reshape(4, 3), split=0)\n"
        "d = tempfile.mkdtemp()\n"
        "ht.save(x, os.path.join(d, 'a.zarr')); ht.save_array_checkpoint(x, os.path.join(d, 'ck'))\n"
        "ok = [ht.load(os.path.join(d, 'a.zarr'), split=0).numpy().sum() == 66,\n"
        "      ht.load_array_checkpoint(os.path.join(d, 'ck')).numpy().sum() == 66,\n"
        "      ht.fft.fft(x).shape == (4, 3), ht.convolve(ht.arange(5), ht.ones(2)).shape == (6,),\n"
        "      ht.sparse.sparse_csr_matrix(np.eye(3, dtype=np.float32)).gnnz == 3,\n"
        "      ht.vmap(lambda r: r * 2)(x).shape == (4, 3),\n"
        "      ht.parallel.ring_map(lambda a, b, s: a, x, x).shape == (4, 3)]\n"
        "print(all(ok))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_flash_step_counts_under_remat_and_for_the_encoder_decoder(chip_smoke):
    """Phase 11b's expected launches of one training step: one of each
    multi-head kernel a self-attention, two forwards a block under remat
    (the recomputation), and a decoder block's cross-attention only where
    the memory is as long as the target."""
    assert chip_smoke.flash_step_counts(8) == {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    assert chip_smoke.flash_step_counts(8, remat=True) == {"flash_fwd": 16, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
    assert chip_smoke.flash_step_counts(6, 6) == {"flash_fwd": 18, "flash_bwd_dq": 18, "flash_bwd_dkv": 18}
    assert chip_smoke.flash_step_counts(6, 6, equal_cross=False)["flash_fwd"] == 12
    assert chip_smoke.flash_step_counts(6, 6, remat=True)["flash_fwd"] == 36
    # the path check takes the per-kernel counts
    chip_smoke._path_counts("remat", {"flash_fwd": 16, "flash_bwd_dq": 8, "flash_bwd_dkv": 8, "flash_gqa_fwd": 0},
                            chip_smoke.MHA_KERNELS, chip_smoke.flash_step_counts(8, remat=True))
    with pytest.raises(RuntimeError, match="remat launches"):
        chip_smoke._path_counts("remat", {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8},
                                chip_smoke.MHA_KERNELS, chip_smoke.flash_step_counts(8, remat=True))


def test_remat_launch_counts_on_the_cpu_model(chip_smoke):
    """The counts flash_step_counts expects are the ones the port's wrappers
    see: the plain versions on the CPU count nothing, so the wrappers'
    calls are counted here through a patched launcher."""
    import heat_tpu_torch as htt
    from unittest import mock

    calls = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    real = fa._launch

    def counting(name, *args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return real(name, *args, **kwargs)

    for remat in (False, True):
        calls = dict.fromkeys(calls, 0)
        lm = htt.nn.models.TransformerLM(31, 16, 4, depth=3, max_len=16, remat=remat, device="cpu")
        with mock.patch.object(fa, "_launch", counting):
            lm(torch.randint(0, 31, (2, 8))).sum().backward()
        assert calls == chip_smoke.flash_step_counts(3, remat=remat)
    calls = dict.fromkeys(calls, 0)
    m = htt.nn.models.Seq2SeqTransformer(31, 29, 16, 4, enc_depth=2, dec_depth=3, max_len=16, device="cpu")
    with mock.patch.object(fa, "_launch", counting):
        m(torch.randint(0, 31, (2, 8)), torch.randint(0, 29, (2, 8))).sum().backward()
    assert calls == chip_smoke.flash_step_counts(2, 3)
    calls = dict.fromkeys(calls, 0)
    with mock.patch.object(fa, "_launch", counting):
        m(torch.randint(0, 31, (2, 8)), torch.randint(0, 29, (2, 6))).sum().backward()
    assert calls == chip_smoke.flash_step_counts(2, 3, equal_cross=False)


def test_drop_share_and_greedy_agreement(chip_smoke):
    assert chip_smoke.drop_share([torch.tensor([3, 100]), torch.tensor([1, 100])]) == pytest.approx(0.02)
    assert chip_smoke.drop_share([torch.tensor([0, 0])]) == 0.0
    logits = torch.tensor([[[0.0, 5.0, 1.0], [2.0, 2.0 - 1e-7, 0.0], [3.0, 0.0, 1.0]]])
    agree = chip_smoke.greedy_agreement(torch.tensor([[1, 1, 0]]), logits)
    assert agree == {"positions": 3, "not_argmax": 1, "not_near_tie": 0, "largest_gap": pytest.approx(1e-7, abs=1e-7)}
    agree = chip_smoke.greedy_agreement(torch.tensor([[2, 0, 0]]), logits)
    assert agree["not_argmax"] == 1 and agree["not_near_tie"] == 1


def test_seq2seq_batches_are_a_copy_task_without_bos(chip_smoke):
    b = chip_smoke.s2s_batches(2, seed=17, batch=3, seq=9)
    assert b.shape == (2, 3, 9) and b.min() >= 1 and b.max() < chip_smoke.S2S_BASE["src_vocab"]
    assert (b == chip_smoke.s2s_batches(2, seed=17, batch=3, seq=9)).all()


def test_flash_bits_needs_a_card():
    """scripts/flash_bits.py (a checkout's flash kernels against another's,
    bit for bit) exits 2 without CUDA, before building or loading anything."""
    out = subprocess.run([sys.executable, str(REPO / "scripts" / "flash_bits.py"), "--parent", str(REPO)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "needs a CUDA card" in out.stderr, out
