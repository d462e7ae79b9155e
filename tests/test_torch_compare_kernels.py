"""The source-comparison tool's arguments and calling conventions.

``utils/compare_kernels.py`` times versions of a kernel's CUDA source on
the card; here, on the CPU, its parsing of ``NAME=SOURCE[@ABI]`` and its
argument types against the C entry each kernel's source declares.
"""

import ctypes
import re

import pytest

from pix2latent_tpu_torch.utils import compare_kernels as CK
from pix2latent_tpu_torch.utils.cuda_build import CSRC_DIR


@pytest.mark.parametrize("kernel", sorted(CK.KERNELS))
def test_no_variant_means_the_package_source(kernel):
    variants = CK.parse_variants(kernel, [])
    assert variants == {"current": (str(CSRC_DIR / f"{kernel}.cu"),
                                    CK.KERNELS[kernel][2])}


def test_variants_keep_their_order_and_calling_convention():
    variants = CK.parse_variants(
        "mod_backward", ["old=a/old.cu@plane", "new=b/new.cu"])
    assert list(variants) == ["old", "new"]
    assert variants["old"] == ("a/old.cu", "plane")
    assert variants["new"] == ("b/new.cu", "plan")


@pytest.mark.parametrize("spec", ["old.cu", "=old.cu", "old=",
                                  "old=old.cu@fused"])
def test_bad_variants_raise(spec):
    with pytest.raises(ValueError):
        CK.parse_variants("mod_backward", [spec])


def _c_params(kernel):
    """Types of the C entry's parameters, as void*, int or float* ."""
    src = (CSRC_DIR / f"{kernel}.cu").read_text()
    entry = CK.KERNELS[kernel][0]
    found = re.search(rf"^int {entry}\(([^)]*)\)", src, re.M)
    assert found, entry
    kinds = []
    for param in found.group(1).split(","):
        param = " ".join(param.split())
        kinds.append("float*" if param.startswith("const float*") else
                     "void*" if "*" in param else "int")
    return kinds


@pytest.mark.parametrize("kernel", sorted(CK.KERNELS))
def test_present_calling_convention_matches_the_source(kernel):
    names = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.POINTER(ctypes.c_float): "float*"}
    argtypes = CK.KERNELS[kernel][1][CK.KERNELS[kernel][2]]
    assert [names[t] for t in argtypes] == _c_params(kernel)
