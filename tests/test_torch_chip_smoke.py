"""chip_smoke.py's host-side parts, on the CPU: the ptxas report it prints
for the bfloat16 forward, what each flash row of its ``kernels`` line says
runs each dtype, and its refusal to run without a card."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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


@pytest.mark.parametrize("name", FLASH_NAMES)
def test_flash_rows_name_each_dtypes_body(chip_smoke, name):
    """Only the bfloat16 forward runs on the tensor cores, from flash_fwd_tc.cuh."""
    cores, sources = chip_smoke.flash_cores(name), chip_smoke.flash_sources(name)
    fwd = name.endswith("_fwd")
    assert cores == {"float32": "CUDA cores", "bfloat16": "mma.sync tensor cores" if fwd else "CUDA cores"}
    assert sources["float32"] == "heat_tpu_torch/ops/csrc/flash_attention.cu"
    assert sources["bfloat16"] == ("heat_tpu_torch/ops/csrc/flash_fwd_tc.cuh" if fwd else sources["float32"])
    assert all((REPO / path).is_file() for path in sources.values())


def test_forward_edge_checks_stay_inside_the_kernels_limits(chip_smoke):
    """The forward-only edge shapes: valid (query rows a multiple of the
    K/V rows, 1 <= d <= 128) and each under the 129 rows from which the
    three-kernel checks start."""
    for bhq, bhk, S, d, causal in chip_smoke.FWD_EDGE_CHECKS + chip_smoke.GQA_FWD_EDGE_CHECKS:
        assert bhq % bhk == 0 and 1 <= d <= 128 and 1 <= S < 129 and isinstance(causal, bool)
    assert {d for *_, d, _ in chip_smoke.FWD_EDGE_CHECKS + chip_smoke.GQA_FWD_EDGE_CHECKS} >= {8, 33, 100}


def test_chip_smoke_without_cuda_exits_2_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2
    assert '"ok"' not in out.stdout
