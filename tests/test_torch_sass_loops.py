"""``kernels/sass_loops``, the SASS opcode counter used to compare two
builds of a kernel, on a short hand-written ``cuobjdump -sass`` listing:
kernels are told apart, loops are found from their backward branches (by
label or by address) and filtered by their FFMA count, and spills count."""

from montecarlooptionspricer_tpu_torch.kernels import sass_loops

LISTING = """
        Function : _Z3fooILi8EEvv
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FFMA R8, R4, R5, R8 ;
        /*0030*/                   FFMA R9, R4, R6, R9 ;
        /*0040*/              @P0 BRA `(.L_x_1) ;
        /*0050*/                   LDL R3, [R1+0x8] ;
        /*0060*/                   FFMA R9, R4, R6, R9 ;
        /*0070*/                   BRA 0x60 ;
        /*0080*/                   EXIT ;
        Function : _Z3barv
        /*0000*/                   STL [R1], R2 ;
        /*0010*/                   EXIT ;
"""


def test_loops_and_spills():
    recs = sass_loops.report(LISTING, "foo", min_ffma=2)
    assert [r["kernel"] for r in recs] == ["_Z3fooILi8EEvv"]
    r = recs[0]
    assert (r["instructions"], r["LDL"], r["STL"]) == (9, 1, 0)
    assert len(r["loops"]) == 1
    start, end, length, body = r["loops"][0]
    assert (start, end, length) == (0x10, 0x40, 4)
    assert body["FFMA"] == 2 and body["LDS.128"] == 1
    one = sass_loops.report(LISTING, "foo", min_ffma=1)[0]["loops"]
    assert [(s, e) for s, e, _, _ in one] == [(0x10, 0x40), (0x60, 0x70)]
    bar = sass_loops.report(LISTING, "bar", min_ffma=1)[0]
    assert (bar["STL"], bar["loops"]) == (1, [])
