"""The port's kernel-build reports, read from sample compiler output: the
``ptxas -v`` register and spill lines and the ``cuobjdump -sass`` opcode
counts that ``chip_smoke.py`` prints for every kernel (the tools
themselves run only where ``nvcc`` is)."""

from pytorch_distributed_tpu_torch.ops import kernel_build

DQ_TC = "_ZN12_GLOBAL__N_118flash_dq_kernel_tcILi64EEEv11FlashParams"
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
