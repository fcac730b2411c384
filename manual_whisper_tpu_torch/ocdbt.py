"""Reader of the JAX package's orbax checkpoints (``convert/from_hf.py``
``save_params``), without orbax, tensorstore or a zstd package.

An orbax checkpoint directory holds:

- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's tree path to its
  keys (``key_type`` 1: a sequence index, 2: a dict key) and value type;
- an OCDBT key-value store (tensorstore's "Optionally-Cooperative
  Distributed B+Tree" on-disk format): ``manifest.ocdbt`` and b-tree node
  and value files under ``d/`` and ``ocdbt.process_<i>/d/``;
- in that store, one zarr v2 array per leaf: ``<path>/.zarray`` (JSON) and
  chunk keys such as ``<path>/0.0``, where ``<path>`` joins the leaf's
  keys with ``.``.

The OCDBT files used here, as tensorstore writes them:

- an encoded file is a header (magic ``uint32be``, total length
  ``uint64le``, format version varint 0, compression varint: 0 none,
  1 zstd), a body (one zstd frame when compressed) and a CRC-32C
  (``uint32le``) of everything before it;
- the manifest (magic ``0x0cdb3a2a``) body is the config (uuid[16],
  manifest kind, max inline value bytes, max decoded node bytes, version
  tree arity log2 ``uint8``, compression method and, for zstd, an
  ``int32le`` level), a data file table, and the versions, column by
  column (generation, root height ``uint8``, root node file / offset /
  length, three statistics, commit time ``uint64le``); the last version is
  the newest; a root with offset and length ``2**64 - 1`` is an empty tree;
- a b-tree node (magic ``0x0cdb20de``) body is its height (``uint8``), a
  data file table and its entries, column by column: key prefix lengths
  (shared with the previous key), key suffix lengths, for interior nodes
  the subtree common prefix lengths, the key suffixes, then for a leaf the
  value lengths, value kinds (0 inline, 1 indirect), the indirect values'
  file ids and offsets, and the inline values' bytes; for an interior node
  the child references (file ids, offsets, lengths) and three statistics;
  a child's keys omit the subtree common prefix of its parent's entry;
- a data file table is ``n``, the paths' prefix lengths shared with the
  previous path (``n - 1``), suffix lengths, base path lengths, then the
  suffixes; a file resolves to the directory + the containing file's base
  path + the entry's path.

Every integer not named otherwise is a LEB128 varint.  Compressed bodies,
chunks and CRCs go through ``native/mwx_zstd.cpp``, built with g++ on first
use like the audio decoders (``audio/native.py``); a failed build, a bad
checksum or any malformed file raises.
"""

from __future__ import annotations

import ctypes
import json
import math
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .audio import native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_NODE = (1 << 64) - 1

_zstd = None
_zstd_lock = threading.Lock()


class FormatError(ValueError):
    """A checkpoint file that does not follow the format."""


def _lib():
    """libmwx_zstd, built on first use; raises when it cannot be."""
    global _zstd
    with _zstd_lock:
        if _zstd is None:
            path = native.build("mwx_zstd")
            if path is None:
                raise RuntimeError(
                    "cannot build the zstd decoder (native/mwx_zstd.cpp): "
                    + native.build_errors.get("mwx_zstd", "g++ failed"))
            lib = ctypes.CDLL(str(path))
            lib.mwx_zstd_decompress.restype = ctypes.c_int64
            lib.mwx_zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64]
            lib.mwx_zstd_decompress_alloc.restype = ctypes.c_int64
            lib.mwx_zstd_decompress_alloc.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_void_p)]
            lib.mwx_zstd_free.restype = None
            lib.mwx_zstd_free.argtypes = [ctypes.c_void_p]
            lib.mwx_zstd_error.restype = ctypes.c_char_p
            lib.mwx_zstd_error.argtypes = [ctypes.c_int64]
            lib.mwx_crc32c.restype = ctypes.c_uint32
            lib.mwx_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            _zstd = lib
        return _zstd


def zstd_decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """Every zstd frame of ``data``, decoded.  ``size``: the most the
    content may take (a buffer of that capacity); None lets the decoder
    grow its buffer.  Raises ValueError on malformed input, a checksum
    mismatch or content over ``size``."""
    lib = _lib()
    data = bytes(data)
    if size is None:
        out = ctypes.c_void_p()
        n = lib.mwx_zstd_decompress_alloc(data, len(data), ctypes.byref(out))
        if n < 0:
            raise ValueError("zstd: " + lib.mwx_zstd_error(n).decode())
        try:
            return ctypes.string_at(out, n)
        finally:
            lib.mwx_zstd_free(out)
    buf = np.empty(max(size, 1), np.uint8)
    n = lib.mwx_zstd_decompress(data, len(data), buf.ctypes.data, size)
    if n < 0:
        raise ValueError("zstd: " + lib.mwx_zstd_error(n).decode())
    return buf[:n].tobytes()


def _zstd_into(data: bytes, out: np.ndarray) -> None:
    """Decode ``data`` into the contiguous array ``out``, which it must
    fill exactly."""
    lib = _lib()
    n = lib.mwx_zstd_decompress(data, len(data), out.ctypes.data, out.nbytes)
    if n < 0:
        raise ValueError("zstd: " + lib.mwx_zstd_error(n).decode())
    if n != out.nbytes:
        raise ValueError(f"zstd: {n} bytes decoded where {out.nbytes} "
                         "were expected")


def crc32c(data: bytes) -> int:
    return int(_lib().mwx_crc32c(bytes(data), len(data)))


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

class _Cursor:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise FormatError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u64le(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                if value >= 1 << 64:
                    raise FormatError(f"{self.what}: varint over 64 bits")
                return value
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def end(self) -> None:
        if self.pos != len(self.data):
            raise FormatError(f"{self.what}: {len(self.data) - self.pos} "
                              "trailing bytes")


def _decode_file(raw: bytes, magic: int, what: str,
                 max_decoded: Optional[int] = None) -> bytes:
    """Check an encoded file's header and CRC-32C; its body, decompressed."""
    if len(raw) < 14 + 4:
        raise FormatError(f"{what}: {len(raw)} bytes, too short")
    cur = _Cursor(raw[:-4], what)
    found = int.from_bytes(cur.raw(4), "big")
    if found != magic:
        raise FormatError(f"{what}: magic {found:#010x}, expected "
                          f"{magic:#010x}")
    length = cur.u64le()
    if length != len(raw):
        raise FormatError(f"{what}: header says {length} bytes, file has "
                          f"{len(raw)}")
    version = cur.varint()
    if version != 0:
        raise FormatError(f"{what}: format version {version}")
    compression = cur.varint()
    (footer,) = np.frombuffer(raw[-4:], "<u4")
    if crc32c(raw[:-4]) != int(footer):
        raise FormatError(f"{what}: CRC-32C mismatch")
    body = raw[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, max_decoded)
    raise FormatError(f"{what}: compression format {compression}")


def _data_file_table(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """(base path, relative path) of each file of a data file table read
    inside a file whose base path is ``base``; paths are relative to the
    store's directory."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files: List[Tuple[str, str]] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise FormatError(f"{cur.what}: bad data file path prefix")
        full = prev[:prefix[i]] + cur.raw(suffix[i])
        if base_len[i] > len(full):
            raise FormatError(f"{cur.what}: bad data file base path")
        prev = full
        files.append((base + full[:base_len[i]].decode("utf-8"),
                      full[base_len[i]:].decode("utf-8")))
    return files


def _keys(cur: _Cursor, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else [0] * n
    keys: List[bytes] = []
    prev = b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise FormatError(f"{cur.what}: bad key prefix length")
        prev = prev[:prefix[i]] + cur.raw(suffix[i])
        keys.append(prev)
        if common[i] > len(prev):
            raise FormatError(f"{cur.what}: bad subtree prefix length")
    return keys, common


class KvStore:
    """Read-only OCDBT key-value store at ``root``, its newest version:
    ``refs`` maps each key, in order, to its inline value or to the
    (file, offset, length) of an indirect one; the b-tree is walked once,
    when the store is opened."""

    def __init__(self, root):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        body = _decode_file(manifest.read_bytes(), MANIFEST_MAGIC,
                            str(manifest))
        cur = _Cursor(body, str(manifest))
        cur.raw(16)                              # uuid
        kind = cur.varint()
        if kind != 0:
            raise FormatError(f"{manifest}: manifest kind {kind} (numbered "
                              "manifests are not read)")
        cur.varint()                             # max inline value bytes
        self._max_node_bytes = cur.varint()
        cur.u8()                                 # version tree arity log2
        method = cur.varint()
        if method == 1:
            cur.raw(4)                           # zstd level, int32le
        elif method != 0:
            raise FormatError(f"{manifest}: compression method {method}")
        files = _data_file_table(cur, "")
        n = cur.varint()
        cur.varints(n)                           # generation numbers
        heights = [cur.u8() for _ in range(n)]
        file_ids, offsets, lengths = (cur.varints(n) for _ in range(3))
        for _ in range(3):                       # statistics
            cur.varints(n)
        for _ in range(n):                       # commit times
            cur.u64le()
        # references to older version tree nodes follow; the newest version
        # is always inline, so they are not read
        if cur.varint() == 0:
            cur.end()
        if n == 0:
            raise FormatError(f"{manifest}: no version")
        self.refs: Dict[bytes, Any] = {}
        if offsets[-1] != _NO_NODE:                # else an empty tree
            self._node(self._file(files, file_ids[-1]), offsets[-1],
                       lengths[-1], heights[-1], b"")

    def _file(self, files: List[Tuple[str, str]], index: int
              ) -> Tuple[str, str]:
        if index >= len(files):
            raise FormatError(f"{self.root}: data file id {index} of "
                              f"{len(files)}")
        return files[index]

    def _read_at(self, file: Tuple[str, str], offset: int,
                 length: int) -> bytes:
        path = self.root / (file[0] + file[1])
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise FormatError(f"{path}: {length} bytes at {offset} past the "
                              "end of the file")
        return data

    def _node(self, file: Tuple[str, str], offset: int, length: int,
              height: int, prefix: bytes) -> None:
        """Add the entries of the subtree at ``file``/``offset`` to
        ``refs``; ``prefix``: the part of its keys its parents hold."""
        what = f"{self.root / (file[0] + file[1])}@{offset}"
        body = _decode_file(self._read_at(file, offset, length), NODE_MAGIC,
                            what, self._max_node_bytes)
        cur = _Cursor(body, what)
        if cur.u8() != height:
            raise FormatError(f"{what}: height differs from its reference")
        files = _data_file_table(cur, file[0])
        n = cur.varint()
        keys, common = _keys(cur, n, interior=height > 0)
        if height > 0:
            file_ids, offsets, lengths = (cur.varints(n) for _ in range(3))
            for _ in range(3):                   # statistics
                cur.varints(n)
            cur.end()
            for i in range(n):
                self._node(self._file(files, file_ids[i]), offsets[i],
                           lengths[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        sizes = cur.varints(n)
        kinds = cur.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            raise FormatError(f"{what}: value kind not 0 or 1")
        file_ids = cur.varints(len(indirect))
        offsets = cur.varints(len(indirect))
        refs = {i: (self._file(files, f), o)
                for i, f, o in zip(indirect, file_ids, offsets)}
        for i in range(n):
            self.refs[prefix + keys[i]] = (*refs[i], sizes[i]) if i in refs \
                else cur.raw(sizes[i])
        cur.end()

    def read(self, key: bytes) -> bytes:
        """The value of ``key`` (KeyError when the store has none)."""
        ref = self.refs[key]
        return ref if isinstance(ref, bytes) else self._read_at(*ref)


# ---------------------------------------------------------------------------
# zarr v2 arrays and the orbax tree
# ---------------------------------------------------------------------------

_DTYPES = {"<f4": np.float32, "<f2": np.float16, "bfloat16": np.int16,
           "|i1": np.int8, "<i4": np.int32, "<i8": np.int64}


def _bf16(bits: np.ndarray):
    """A bf16 leaf from its 16-bit integer view: numpy's ``bfloat16`` where
    that dtype is registered (``ml_dtypes`` imported, as in the JAX
    package's processes), else a CPU ``torch.bfloat16`` tensor; both cross
    ``convert.tensor_from_numpy``."""
    try:
        return bits.view(np.dtype("bfloat16"))
    except TypeError:
        import torch
        return torch.from_numpy(bits).view(torch.bfloat16)


def read_zarr(store: KvStore, name: str):
    """The zarr v2 array ``name`` of ``store`` as numpy, C order."""
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in store.refs:
        raise KeyError(f"{store.root}: no array {name!r}")
    meta = json.loads(store.read(meta_key))
    if meta.get("zarr_format") != 2:
        raise FormatError(f"{name}: zarr format {meta.get('zarr_format')}")
    dtype = _DTYPES.get(meta["dtype"])
    if dtype is None:
        raise FormatError(f"{name}: dtype {meta['dtype']!r} is not read "
                          f"(read: {sorted(_DTYPES)})")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise FormatError(f"{name}: order {meta.get('order')!r}, filters "
                          f"{meta.get('filters')!r}; read: C, none")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise FormatError(f"{name}: compressor {compressor!r}; read: zstd, "
                          "none")
    shape = tuple(int(d) for d in meta["shape"])
    chunks = tuple(int(d) for d in meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise FormatError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if fill is None:
        fill = 0
    elif meta["dtype"] == "bfloat16":   # the value's top 16 bits
        fill = np.array(fill, np.float32).view(np.uint32) >> 16
        fill = np.array(fill, np.uint16).view(np.int16)
    out = np.full(shape, fill, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = sep.join(str(i) for i in index) if shape else "0"
        chunk_key = f"{name}/{key}".encode()
        if chunk_key not in store.refs:
            continue
        raw = store.read(chunk_key)
        if compressor is None:
            nbytes = math.prod(chunks) * np.dtype(dtype).itemsize
            if len(raw) != nbytes:
                raise FormatError(f"{name}/{key}: {len(raw)} bytes, "
                                  f"expected {nbytes}")
            chunk = np.frombuffer(raw, dtype).reshape(chunks)
        else:
            chunk = np.empty(chunks, dtype)
            _zstd_into(raw, chunk)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return _bf16(out) if meta["dtype"] == "bfloat16" else out


def read_checkpoint(path) -> Dict[str, Any]:
    """The tree an orbax ``StandardCheckpointer`` saved at ``path``, as its
    ``restore`` gives it without a target: nested dicts (sequence keys make
    lists) of numpy arrays (a ``jax.Array`` leaf comes back as numpy)."""
    path = Path(path)
    meta_path = path / "_METADATA"
    if not meta_path.exists():
        raise FileNotFoundError(
            f"Metadata file (named _METADATA) does not exist at {path}.")
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise FormatError(f"{path}: only OCDBT with zarr v2 is read")
    store = KvStore(path)
    tree: Dict[str, Any] = {}
    for item in meta["tree_metadata"].values():
        keys = item["key_metadata"]
        value_type = item["value_metadata"].get("value_type")
        if value_type not in ("np.ndarray", "jax.Array") \
                or item["value_metadata"].get("skip_deserialize"):
            raise FormatError(f"{path}: leaf {[k['key'] for k in keys]} has "
                              f"value type {value_type!r}")
        leaf = read_zarr(store, ".".join(k["key"] for k in keys))
        # a sequence is gathered as a dict of int keys, made a list below
        path_keys = [int(k["key"]) if k["key_type"] == 1 else k["key"]
                     for k in keys]
        node = tree
        for key in path_keys[:-1]:
            node = node.setdefault(key, {})
        node[path_keys[-1]] = leaf
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise FormatError(f"sequence indices {sorted(node)} are not "
                              "0..n-1")
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
