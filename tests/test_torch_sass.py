"""vireo_tpu_torch.ops.sass: reading `cuobjdump` output and comparing two
libraries' functions. cuobjdump and nvcc run only where the CUDA toolkit
is; these tests read output of the toolkit's format."""

import pytest

from vireo_tpu_torch.ops import _launch, sass

SASS = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : _Z6kernelILi0EEvPKhPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
                                                                                     /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                              /* 0x0000000000007919 */
                                                                                     /* 0x000e220000002100 */
        /*0020*/              @!P0 IADD3.X R2, R0, 0x1, RZ ;                       /* 0x0000000100028810 */
                                                                                     /* 0x001fca0007ffe0ff */
        /*0030*/                   EXIT ;                                          /* 0x000000000000794d */
                                                                                     /* 0x000fea0003800000 */
		..........

		Function : _Z6kernelILi1EEvPKhPf
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
                                                                                     /* 0x000fe40000000800 */
        /*0010*/                   EXIT ;                                          /* 0x000000000000794d */
                                                                                     /* 0x000fea0003800000 */
"""

RES_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit
Resource usage:
 Common:
  GLOBAL:0
 Function _Z6kernelILi1EEvPKhPf:
  REG:8 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:544 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z6kernelILi0EEvPKhPf:
  REG:26 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:560 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

K0, K1 = "_Z6kernelILi0EEvPKhPf", "_Z6kernelILi1EEvPKhPf"


def test_functions_keep_each_instruction_without_address_or_encoding():
    fns = sass.functions(SASS)
    assert list(fns) == [K0, K1]
    assert fns[K0] == ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X",
                       "@!P0 IADD3.X R2, R0, 0x1, RZ", "EXIT"]
    assert fns[K1] == ["LDC R1, c[0x0][0x28]", "EXIT"]


def test_registers_and_opcode_counts():
    assert sass.registers(RES_USAGE) == {K0: 26, K1: 8}
    assert sass.opcode_counts(sass.functions(SASS)[K0]) == {
        "LDC": 1, "S2R": 1, "IADD3": 1, "EXIT": 1}


def test_plain_names_drop_the_anonymous_namespace_hash():
    a, b = ("_ZN49_GLOBAL__N__%s_16_packed_counts_cu_b4e1cc82"
            "13loglik_kernelILi16EEEvPKh" % h for h in ("e420b85c",
                                                        "02e9d6cd"))
    assert sass.plain_names(a) == sass.plain_names(b) == (
        "_ZN11_GLOBAL__N_13loglik_kernelILi16EEEvPKh")
    assert sass.plain_names("x %s y %s" % (a, b)).count("11_GLOBAL__N_13") == 2
    assert sass.plain_names(K0) == K0


def test_compare_matches_a_renamed_function_by_its_code():
    """A template that gained a defaulted parameter (a longer name) with
    the same instructions is the same function; with other instructions
    it is in one library only."""
    fns, regs = sass.functions(SASS), sass.registers(RES_USAGE)
    longer = K1.replace("ILi1E", "ILi1ELi2E")
    lines, bad = sass.compare(({K0: fns[K0], longer: fns[K1]}, regs),
                              (fns, regs))
    assert bad == 0 and "(there %s)" % K1 in lines[1]
    lines, bad = sass.compare(({K0: fns[K0], longer: ["EXIT"]}, regs),
                              (fns, regs))
    assert bad == 2 and sorted(ln.split(":")[0] for ln in lines[1:]) == [
        "only in the other", "only in this checkout"]


@pytest.mark.parametrize("edit,differ", [
    (lambda f: f, 0),
    (lambda f: {K0: f[K0], K1: f[K1] + ["NOP"]}, 1),
    (lambda f: {K0: f[K0]}, 1),
], ids=["same", "one-differs", "one-missing"])
def test_compare_counts_functions_that_differ(edit, differ):
    fns, regs = sass.functions(SASS), sass.registers(RES_USAGE)
    lines, bad = sass.compare((fns, regs), (edit(fns), regs))
    assert bad == differ and len(lines) == 2
    assert sum(not ln.startswith("same") for ln in lines) == differ


def test_on_cpu_takes_cpu_tensors_and_refuses_other_devices():
    import torch
    assert _launch.on_cpu("k", torch.zeros(1))
    with pytest.raises(ValueError, match="k runs on CUDA or CPU"):
        _launch.on_cpu("k", torch.zeros(1, device="meta"))
