"""The port's kernel-build reports, read from sample compiler output: the
``ptxas -v`` register and spill lines and the ``cuobjdump -sass`` opcode
counts that ``chip_smoke.py`` prints for every kernel (the tools
themselves run only where ``nvcc`` is), and ``chip_smoke.py``'s check
of the flash routes over such a report."""

import importlib.util
from pathlib import Path

import pytest

from pytorch_distributed_tpu_torch.ops import kernel_build

DQ_TC = ("_ZN12_GLOBAL__N_118flash_dq_kernel_tcI13__nv_bfloat16Li64EEEv"
         "11FlashParams")
DQ_F32 = "_ZN12_GLOBAL__N_115flash_dq_kernelIfLi64EEEv11FlashParams"

PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DQ_TC}' for 'sm_90a'
ptxas info    : Function properties for {DQ_TC}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 242 registers, used 1 barriers, 528 bytes cmem[0]
ptxas info    : Compiling entry function '{DQ_F32}' for 'sm_90a'
ptxas info    : Function properties for {DQ_F32}
    24 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 528 bytes cmem[0]
"""

SASS = f"""\
\tcode for sm_90a
\t\tFunction : {DQ_TC}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0100*/                   HMMA.16816.F32.BF16 R4, R20, R28, R4 ;
        /*0110*/               @P0 HMMA.16816.F32.BF16 R8, R20, R30, R8 ;
        /*0120*/              @!P1 LDSM.16.MT88.4 R8, [R3] ;
        /*0130*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
\t\tFunction : {DQ_F32}
        /*0000*/                   FFMA R1, R2, R3, R1 ;
        /*0010*/                   EXIT ;
"""


def test_parse_ptxas_reads_registers_and_spills_per_kernel():
    report = kernel_build.parse_ptxas(PTXAS)
    assert report == {
        DQ_TC: dict(registers=242, spill_stores=0, spill_loads=0),
        DQ_F32: dict(registers=128, spill_stores=16, spill_loads=24),
    }


def test_parse_sass_counts_tensor_core_opcodes_per_kernel():
    """Modifiers and predicates do not hide an opcode; other opcodes
    (the predicated LDSM) do not count."""
    counts = kernel_build.parse_sass(SASS)
    assert counts == {
        DQ_TC: dict(HMMA=2, HGMMA=1),
        DQ_F32: dict(HMMA=0, HGMMA=0),
    }
    assert kernel_build.parse_sass("no functions here") == {}


# --------------------------------------------------------------------------
# chip_smoke.py's route check over the flash kernels' build report
# --------------------------------------------------------------------------

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FWD_TC = ("_ZN12_GLOBAL__N_119flash_fwd_kernel_tcI13__nv_bfloat16Li64EEEv"
          "11FlashParams")
FWD_TC_F16 = ("_ZN12_GLOBAL__N_119flash_fwd_kernel_tcI6__halfLi64EEEv"
              "11FlashParams")
FWD_BF16 = ("_ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li64EEEv"
            "11FlashParams")


def test_flash_label_names_kernel_dtype_and_head_dim():
    assert chip_smoke.flash_label(DQ_TC) == "flash_dq_kernel_tc bfloat16 D=64"
    assert chip_smoke.flash_label(DQ_F32) == "flash_dq_kernel float32 D=64"
    assert chip_smoke.flash_label(FWD_TC) == (
        "flash_fwd_kernel_tc bfloat16 D=64")
    assert chip_smoke.flash_label(FWD_TC_F16) == (
        "flash_fwd_kernel_tc float16 D=64")
    assert chip_smoke.flash_label(FWD_BF16) == (
        "flash_fwd_kernel bfloat16 D=64")
    assert chip_smoke.flash_label("_Z12paged_kernelv") is None


def _good_report():
    """What the library must hold: the three bf16 and the three fp16
    kernels on the tensor cores and the three f32 ones on the CUDA cores,
    at each head_dim."""
    report = {}
    for d in (16, 32, 64, 96, 128, 256):
        for k in ("fwd", "dq", "dkv"):
            for t in ("bfloat16", "float16"):
                report[f"flash_{k}_kernel_tc {t} D={d}"] = dict(
                    registers=128, spill_stores=0, spill_loads=0, HMMA=8,
                    HGMMA=0)
            report[f"flash_{k}_kernel float32 D={d}"] = dict(
                registers=128, spill_stores=0, spill_loads=0, HMMA=0,
                HGMMA=0)
    report["_Z12paged_kernelv"] = dict(registers=64)
    return report


def _no_tc(r):
    r["flash_fwd_kernel_tc bfloat16 D=128"].update(HMMA=0)


def _spills(r):
    r["flash_fwd_kernel_tc bfloat16 D=32"].update(spill_stores=8)


def _bf16_cuda_cores(r):
    r["flash_fwd_kernel bfloat16 D=64"] = dict(HMMA=0, HGMMA=0)


def _f32_on_tensor_cores(r):
    r["flash_fwd_kernel float32 D=16"].update(HMMA=4)


def _missing(r):
    del r["flash_fwd_kernel_tc bfloat16 D=16"]


def _f16_missing(r):
    del r["flash_dkv_kernel_tc float16 D=64"]


def _f16_spills(r):
    r["flash_fwd_kernel_tc float16 D=64"].update(spill_loads=4)


def _f16_cuda_cores(r):
    r["flash_dq_kernel float16 D=64"] = dict(HMMA=0, HGMMA=0)


def _f16_no_tc(r):
    r["flash_dq_kernel_tc float16 D=32"].update(HMMA=0)


@pytest.mark.parametrize("spoil,what", [
    (_no_tc, "D=128: no tensor-core instructions"),
    (_spills, "D=32 spills"),
    (_bf16_cuda_cores, "unexpected flash_fwd_kernel bfloat16 D=64"),
    (_f32_on_tensor_cores, "float32 D=16: tensor-core instructions"),
    (_missing, "missing flash_fwd_kernel_tc bfloat16 D=16"),
    (_f16_missing, "missing flash_dkv_kernel_tc float16 D=64"),
    (_f16_spills, "flash_fwd_kernel_tc float16 D=64 spills"),
    (_f16_cuda_cores, "unexpected flash_dq_kernel float16 D=64"),
    (_f16_no_tc, "float16 D=32: no tensor-core instructions"),
])
def test_check_flash_routes_refuses_a_wrong_build(spoil, what):
    report = _good_report()
    chip_smoke.check_flash_routes(report)   # the right build passes
    spoil(report)
    with pytest.raises(AssertionError, match=what):
        chip_smoke.check_flash_routes(report)


def test_check_flash_routes_allows_spills_at_head_dim_128():
    report = _good_report()
    report["flash_fwd_kernel_tc bfloat16 D=128"].update(spill_stores=8)
    chip_smoke.check_flash_routes(report)


# --------------------------------------------------------------------------
# the paged-attention kernels' labels and routes
# --------------------------------------------------------------------------

PAGED_TC = ("_ZN12_GLOBAL__N_122paged_decode_kernel_tcILi128EEEvNS_"
            "11PagedParamsE")
PAGED_F32 = "_ZN12_GLOBAL__N_119paged_decode_kernelIfLi64EEEvNS_11PagedParamsE"
COMBINE_BF16 = ("_ZN12_GLOBAL__N_120paged_combine_kernelI13__nv_bfloat16EEvNS_"
                "11PagedParamsE")


def test_paged_label_names_kernel_dtype_and_head_dim():
    assert chip_smoke.paged_label(PAGED_TC) == (
        "paged_decode_kernel_tc bfloat16 D=128")
    assert chip_smoke.paged_label(PAGED_F32) == (
        "paged_decode_kernel float32 D=64")
    assert chip_smoke.paged_label(COMBINE_BF16) == (
        "paged_combine_kernel bfloat16")
    assert chip_smoke.paged_label(DQ_TC) is None


def _good_paged_report():
    """The bf16 split kernel on the tensor cores and the f32 one on the
    CUDA cores at each head_dim, and a combine kernel per dtype."""
    report = {"paged_combine_kernel bfloat16": dict(HMMA=0, HGMMA=0),
              "paged_combine_kernel float32": dict(HMMA=0, HGMMA=0)}
    for d in (64, 96, 128, 256):
        report[f"paged_decode_kernel_tc bfloat16 D={d}"] = dict(
            registers=128, spill_stores=0, spill_loads=0, HMMA=16, HGMMA=0)
        report[f"paged_decode_kernel float32 D={d}"] = dict(
            registers=96, spill_stores=0, spill_loads=0, HMMA=0, HGMMA=0)
    report.update(_good_report())
    return report


def _paged_no_tc(r):
    r["paged_decode_kernel_tc bfloat16 D=256"].update(HMMA=0)


def _paged_spills(r):
    r["paged_decode_kernel_tc bfloat16 D=128"].update(spill_loads=4)


def _paged_bf16_cuda_cores(r):
    r["paged_decode_kernel bfloat16 D=128"] = dict(HMMA=0, HGMMA=0)


def _paged_f32_on_tensor_cores(r):
    r["paged_decode_kernel float32 D=64"].update(HGMMA=2)


def _paged_no_combine(r):
    del r["paged_combine_kernel float32"]


@pytest.mark.parametrize("spoil,what", [
    (_paged_no_tc, "D=256: no tensor-core instructions"),
    (_paged_spills, "D=128 spills"),
    (_paged_bf16_cuda_cores, "unexpected paged_decode_kernel bfloat16"),
    (_paged_f32_on_tensor_cores, "float32 D=64: tensor-core instructions"),
    (_paged_no_combine, "missing paged_combine_kernel float32"),
])
def test_check_paged_routes_refuses_a_wrong_build(spoil, what):
    report = _good_paged_report()
    chip_smoke.check_paged_routes(report)   # the right build passes
    chip_smoke.check_flash_routes(report)   # ... and leaves flash alone
    spoil(report)
    with pytest.raises(AssertionError, match=what):
        chip_smoke.check_paged_routes(report)


def test_check_paged_routes_allows_spills_at_head_dim_256():
    report = _good_paged_report()
    report["paged_decode_kernel_tc bfloat16 D=256"].update(spill_stores=8)
    chip_smoke.check_paged_routes(report)


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/mma_sm90.cuh: an edit to a header, like
    one to the source, names a new library, so a stale one never loads."""
    monkeypatch.setattr(kernel_build, "SOURCE_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = kernel_build.library_path("k")
    assert kernel_build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = kernel_build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert kernel_build.library_path("k") not in (first, second)
    assert first.name.startswith("libk-") and first.suffix == ".so"
