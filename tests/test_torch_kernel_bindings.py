"""The ctypes signatures the ``ops/`` modules declare for their CUDA sources,
held against the ``extern "C"`` block of each ``csrc/*.cu`` on the CPU.

A slip in a declared argument list would show only on the card, as a crash
or as wrong numbers; here every C entry of every source must be declared
once, by the module that loads that source, with the C parameter list's
types: ``int`` as ``c_int`` (the return too), a pointer as ``c_void_p`` or
a ``POINTER`` of its own element type.
"""

import ctypes
import importlib
import pkgutil
import re

import pytest

import pix2latent_tpu_torch.ops as ops
from pix2latent_tpu_torch.utils.cuda_build import CSRC_DIR

_EXTERN = re.compile(r'^extern "C" \{$(.*?)^\}  // extern "C"$', re.M | re.S)
_ENTRY = re.compile(r"^int (\w+)\(([^)]*)\)", re.M)
# the ctypes a pointer parameter may be declared as, by its element type
_POINTEES = {"void": (), "float": (ctypes.c_float,),
             "double": (ctypes.c_double,)}


def _c_entries(source):
    """``{entry: parameter kinds}`` of the ``extern "C"`` block of
    ``csrc/<source>``, each kind ``int`` or ``<element>*``."""
    block = _EXTERN.search((CSRC_DIR / source).read_text())
    assert block, f"{source}: no extern \"C\" block"
    return {name: [_c_params(p) for p in params.split(",")]
            for name, params in _ENTRY.findall(block.group(1))}


def _c_params(param):
    """The kind of one C parameter: ``int``, or its element type and ``*``."""
    param = " ".join(param.split()).removeprefix("const ")
    if "*" in param:
        return param.split("*")[0].strip() + "*"
    assert param.split()[0] == "int", param
    return "int"


def _declared():
    """``{source: SIGNATURES}`` of every ``ops/`` module that loads a
    CUDA source."""
    tables = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        if hasattr(mod, "SIGNATURES"):
            assert mod.SOURCE not in tables, mod.SOURCE
            tables[mod.SOURCE] = mod.SIGNATURES
    return tables


_CASES = [(source, entry)
          for source in sorted(p.name for p in CSRC_DIR.glob("*.cu"))
          for entry in _c_entries(source)]
assert _CASES, f"no C entries found under {CSRC_DIR}"


def _matches(kind, ctype):
    if kind == "int":
        return ctype is ctypes.c_int
    element = kind[:-1]
    assert element in _POINTEES, kind
    return ctype is ctypes.c_void_p or any(
        ctype is ctypes.POINTER(t) for t in _POINTEES[element])


@pytest.mark.parametrize("source,entry", _CASES)
def test_declared_signature_matches_the_source(source, entry):
    tables = _declared()
    assert source in tables, f"no ops/ module declares {source}"
    # every C entry declared, and no declared entry missing from the source
    assert set(tables[source]) == set(_c_entries(source)), source
    restype, argtypes = tables[source][entry]
    params = _c_entries(source)[entry]
    assert restype is ctypes.c_int, entry
    assert len(argtypes) == len(params), (entry, argtypes, params)
    for i, (kind, ctype) in enumerate(zip(params, argtypes)):
        assert _matches(kind, ctype), (entry, i, kind, ctype)
