"""``lsdm_tpu_torch/ptxas_report.py``'s parsers on canned compiler output:
no nvcc is needed to check how it reads ptxas's report and the SASS."""

import subprocess
import types

from lsdm_tpu_torch import kernels, ptxas_report

PTXAS = """\
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelv
    192 bytes stack frame, 324 bytes spill stores, 464 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 192 bytes cumulative stack size
ptxas info    : Function properties for _Z5tilesILi0EEvv
    0 bytes stack frame, 56 bytes spill stores, 584 bytes spill loads
"""

# a kernel body that calls one function at 0x0100; the function's loop
# (0x0120-0x0150) holds FFMAs and one spill load, its epilogue another
SASS = """\
        /*0000*/                   LDL R2, [R1] ;
        /*0010*/                   CALL.REL.NOINC 0x100 ;
        /*0020*/                   EXIT ;
        /*0100*/                   LDL R4, [R1+0x8] ;
        /*0110*/                   MOV R5, RZ ;
        /*0120*/                   FFMA R6, R7, R8, R6 ;
        /*0130*/                   LDL R9, [R1+0x4] ;
        /*0140*/                   FFMA R6, R7, R9, R6 ;
        /*0150*/              @P0 BRA 0x120 ;
        /*0160*/                   RET.REL.NODEC R2 0x0 ;
"""


def _fake_run(stdout="", stderr=""):
    return lambda cmd, **kw: types.SimpleNamespace(stdout=stdout, stderr=stderr)


def test_ptxas_report_reads_each_function(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", _fake_run(stderr=PTXAS))
    funcs = ptxas_report.ptxas("sa_fused", "out.cubin")
    assert funcs == [
        {"function": "_Z6kernelv", "stack": 192, "spill_stores": 324,
         "spill_loads": 464, "registers": 128},
        {"function": "_Z5tilesILi0EEvv", "stack": 0, "spill_stores": 56,
         "spill_loads": 584}]


def test_sass_parts_split_at_calls_and_find_spills_in_fma_loops(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", _fake_run(stdout=SASS))
    parts = ptxas_report.sass_parts("out.cubin")
    assert parts == [
        {"at": "0x0", "instructions": 3, "ffma": 0, "ldl": 1,
         "ldl_in_fma_loops": 0},
        {"at": "0x100", "instructions": 7, "ffma": 2, "ldl": 2,
         "ldl_in_fma_loops": 1}]


# two functions; predicated and dotted opcodes count by their mnemonic
SASS_FUNCS = """\
        Function : _Z17chain_bf16_kernelILi4EEv8TailArgs
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R8, R12, R4, R8 ;
        /*0020*/              @!P0 HMMA.16816.F32.BF16 R16, R12, R6, R16 ;
        /*0030*/                   MUFU.EX2 R3, R3 ;
        /*0040*/                   BAR.SYNC R5, R6 ;
        /*0050*/              @P1  BRA 0x20 ;
        /*0060*/                   EXIT ;
        Function : _Z15emb_g_kernel8EmbGArgs
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0010*/              @P1  FFMA R2, R3, R4, R2 ;
        /*0020*/                   EXIT ;
"""


def test_sass_counts_count_each_functions_opcodes(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", _fake_run(stdout=SASS_FUNCS))
    counts = ptxas_report.sass_counts("out.cubin")
    assert counts == {
        "_Z17chain_bf16_kernelILi4EEv8TailArgs": {
            "HMMA": 2, "HGMMA": 0, "FFMA": 0, "LDSM": 1, "MUFU": 1, "BAR": 1,
            "BRA": 1},
        "_Z15emb_g_kernel8EmbGArgs": {
            "HMMA": 0, "HGMMA": 1, "FFMA": 1, "LDSM": 0, "MUFU": 0, "BAR": 0,
            "BRA": 0}}


# a kernel whose product loop (0x0020-0x0050) holds HMMAs and one spill
# load, and whose FFMA loop (0x0070-0x0090) holds another; then a second
# function of one instruction
SASS_MMA = """\
        Function : _Z6kernelv
        /*0000*/                   LDL R2, [R1] ;
        /*0010*/                   MOV R5, RZ ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0030*/                   LDL R9, [R1+0x4] ;
        /*0040*/                   LDSM.16.M88.4 R8, [R3] ;
        /*0050*/              @P0 BRA 0x20 ;
        /*0060*/                   MOV R6, RZ ;
        /*0070*/                   FFMA R6, R7, R8, R6 ;
        /*0080*/                   LDL R10, [R1+0x8] ;
        /*0090*/              @P1 BRA 0x70 ;
        /*00a0*/                   EXIT ;
        Function : _Z5otherv
        /*0000*/                   EXIT ;
"""


def test_loop_spills_tell_mma_loops_from_ffma_loops(monkeypatch):
    monkeypatch.setattr(kernels, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", _fake_run(stdout=SASS_MMA))
    assert ptxas_report.loop_spills("out.cubin") == {
        "_Z6kernelv": {"ldl": 3, "ldl_in_mma_loops": 1, "ldl_in_ffma_loops": 1},
        "_Z5otherv": {"ldl": 0, "ldl_in_mma_loops": 0, "ldl_in_ffma_loops": 0}}
    bodies = ptxas_report.sass_bodies("out.cubin")
    assert len(bodies["_Z6kernelv"]) == 11 and bodies["_Z5otherv"] == (("0000", "EXIT "),)
