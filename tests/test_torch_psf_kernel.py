"""The motion PSF's kernel (csrc/psf.cu) as far as a CPU can check it,
and the C entries' ctypes signatures.

On a CPU device `make_psf("motion", ...)` takes the plain version,
`motion_blur_kernel`, to the bit, and launches nothing. The kernel itself
runs only on a card (tests/test_torch_kernels_cuda.py holds it bitwise to
the plain version there); here its source is read as text: every C entry
of the library has the argument types that `_build.SIGNATURES` gives
ctypes, and the kernel rounds each float product and sum on its own
(__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc contracts none of them
into an FMA), as torch's separate kernels round them.
"""

import ctypes
import re

import pytest
import torch

from fft_restoration_tpu_torch.ops.kernels import _build, launch_counts
from fft_restoration_tpu_torch.ops.kernels.psf import motion_psf
from fft_restoration_tpu_torch.ops.psf import make_psf, motion_blur_kernel

CTYPE = {ctypes.c_void_p: "void*", ctypes.c_int: "int", ctypes.c_longlong: "long long",
         ctypes.c_float: "float", ctypes.c_double: "double"}


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_make_psf_motion_on_the_cpu_is_the_plain_version():
    before = launch_counts["motion_psf"]
    for size, angle in ((1, 0.0), (9, 45.0), (20, 179.999), (50, 30.0), (60, -30.0),
                        (33, 400.0)):
        psf = make_psf("motion", size, angle, "cpu")
        assert psf.dtype == torch.float32 and psf.shape == (size, size)
        assert torch.equal(_bits(psf), _bits(motion_blur_kernel(size, angle, "cpu")))
        assert torch.equal(_bits(motion_psf(size, angle, torch.device("cpu"))), _bits(psf))
    assert launch_counts["motion_psf"] == before


def test_motion_psf_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device meta"):
        motion_psf(9, 30.0, "meta")


def _c_params(name):
    """The parameter types of `extern "C" int name(...)` in csrc/, with
    the sources' one-argument macros (CROSS_ARGS) expanded."""
    text = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    text = text.replace("\\\n", " ")
    macros = dict(re.findall(r"#define (\w+)\(\w+\)\s+(.*)", text))
    decl = re.search(r'extern "C" int ' + name + r"\s*\(", text)
    assert decl, f"no C declaration of {name}"
    depth, end = 1, decl.end()
    while depth:
        depth += {"(": 1, ")": -1}.get(text[end], 0)
        end += 1
    params = re.sub(r"(\w+)\(\w+\)", lambda m: macros.get(m.group(1), m.group(0)),
                    text[decl.end():end - 1])
    out = []
    for p in params.split(","):
        words = re.sub(r"\b(const|unsigned)\b", " ", p).replace("*", " * ").split()
        out.append("void*" if "*" in words else " ".join(words[:-1]))
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_declarations(name):
    assert _c_params(name) == [CTYPE[t] for t in _build.SIGNATURES[name]]


def _bare_float_ops(source):
    """The statements of motion_psf_kernel that compute a float with a
    bare *, +, - or / (which nvcc may contract into an FMA), leaving out
    the casts of int and double constants and line_sample's int
    arguments."""
    body = source[source.index("void motion_psf_kernel("):]
    body = body[body.index("{") + 1:body.index("\n}\n")]
    bad = []
    for stmt in body.split(";"):
        stmt = " ".join(stmt.split())
        if not re.match(r"(const float |float |v = |out\[e\] = )", stmt):
            continue
        expr = re.sub(r"\(float\)\([^()]*\)|line_sample\([^()]*\)|\(int\)", " c ", stmt)
        expr = expr[expr.index("=") + 1:]
        if re.search(r"[\w)]\s*[-+*/]\s*[\w(]", expr):
            bad.append(stmt)
    return bad


def test_psf_kernel_rounds_each_op_on_its_own():
    assert "psf.cu" in _build.SOURCES
    assert ("psf.cu", "psf", ()) in _build.units()
    source = (_build.CSRC / "psf.cu").read_text()
    assert _bare_float_ops(source) == []
    # the check sees a bare product where one slips in
    planted = source.replace("__fmul_rn(alpha, alpha)", "alpha * alpha")
    assert [s for s in _bare_float_ops(planted) if "alpha * alpha" in s]
