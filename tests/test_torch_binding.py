"""PyTorch port: the ctypes binding of the CUDA kernels' C entry points.

``ops/_build.py`` lists each entry point's argument types by hand.  ctypes
does not know the C declaration: a pointer bound as ``c_int`` is cut to 32
bits without an error, and a missing argument reads whatever is on the
stack.  So the ``extern "C" int mwx_*(...)`` declarations are parsed out of
``csrc/*.cu`` and ``SIGNATURES`` is held against them, symbol by symbol.
Runs on the CPU: only the sources are read, nothing is built.
"""

import ctypes
import re

import pytest

from manual_whisper_tpu_torch.ops import _build

_DECL = re.compile(r'extern\s+"C"\s+int\s+(mwx_\w+)\s*\(([^)]*)\)', re.S)


def _declared():
    """{library: {symbol: [ctypes type per C parameter]}} from csrc/*.cu."""
    found = {}
    for path in sorted(_build.CSRC_DIR.glob("*.cu")):
        for symbol, params in _DECL.findall(path.read_text()):
            types = []
            for param in params.split(","):
                words = param.replace("*", " * ").split()
                if "*" in words:
                    types.append(ctypes.c_void_p)
                elif words[:-1] == ["int"]:
                    types.append(ctypes.c_int)
                else:
                    raise AssertionError(f"{path.name}: {symbol} takes "
                                         f"{param.strip()!r}: neither a "
                                         f"pointer nor an int")
            found.setdefault(path.stem, {})[symbol] = types
    return found


DECLARED = _declared()
SYMBOLS = sorted((lib, sym) for lib, syms in DECLARED.items() for sym in syms)


def test_every_entry_point_is_bound_and_no_other():
    bound = sorted((lib, sym) for lib, syms in _build.SIGNATURES.items()
                   for sym in syms)
    assert bound == SYMBOLS
    assert SYMBOLS, "no extern \"C\" entry point found under csrc/"


@pytest.mark.parametrize("lib,symbol", SYMBOLS)
def test_argtypes_match_the_c_declaration(lib, symbol):
    declared = DECLARED[lib][symbol]
    bound = _build.SIGNATURES[lib][symbol]
    assert len(bound) == len(declared)
    assert bound == declared


def test_parser_tells_pointers_from_ints(tmp_path, monkeypatch):
    (tmp_path / "toy.cu").write_text(
        'extern "C" int mwx_toy(const void* a, void *b,\n'
        '                       int n, void* stream) { return 0; }\n')
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert _declared() == {"toy": {"mwx_toy": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}}
