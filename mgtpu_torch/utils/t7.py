"""Torch7 `.t7` serialization — pure-Python reader and writer.

The reference ecosystem's canonical artifacts are torch.save blobs:
the pre-whitened CIFAR bundle (`dataset/cifar100-whitened/dataset.lua:44`),
the generated MNIST task sets (`utils/mnist-cluttered/segmentation.lua:70`),
and trained model checkpoints (`multigpu.lua:105`). This module lets the
port read any of them (`mgtpu_torch/tools/read_t7.py`,
`mgtpu_torch/tools/import_t7_model.py`) and write fixtures for
round-trip tests. It is the port's own copy of `mgtpu/utils/t7.py`
(numpy, ``re`` and ``struct`` only; no torch): the two read and write
the same bytes.

Format (torch7 File.lua writeObject + THDiskFile.c, re-implemented from
the published on-disk layout): a stream of tagged objects,

    int32 tag     0=nil 1=number 2=string 3=table 4=torch-class
                  5=boolean 6=function 7/8=recursive function
    number        float64
    string        int32 size + raw bytes
    table         int32 ref-index; if new: int32 npairs + npairs *
                  (key object, value object)
    torch-class   int32 ref-index; if new: version string ("V <n>",
                  legacy files put the class name here), class name
                  string, then the class payload:
      *Tensor     int32 ndim, int64 size[ndim], int64 stride[ndim],
                  int64 storageOffset (1-based), storage object
      *Storage    int64 size, raw elements
      other       one table object holding the instance fields
    boolean       int32 0/1
    function      int32 ref-index; if new: dumped bytecode string +
                  upvalues table (read and kept opaque here)

Ref-indices implement shared-structure/cycle preservation: the second
occurrence of an object serializes as tag + index only. Binary files
are little-endian with 4-byte ints and 8-byte longs (the x86-64 Torch
build that produced every published blob); ascii files write one
whitespace-terminated token per scalar and size-prefixed raw bytes for
strings (`torch.save(path, obj, 'ascii')`).
"""

from __future__ import annotations

import re
import struct
from typing import Any, BinaryIO, Dict, Optional

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

# torch class name -> numpy element dtype. Cuda* payloads are written
# by cutorch with the same layout as their CPU counterparts.
_ELEMENT_DTYPES = {
    "Double": np.float64,
    "Float": np.float32,
    "Half": np.float16,
    "Long": np.int64,
    "Int": np.int32,
    "Short": np.int16,
    "Char": np.int8,
    "Byte": np.uint8,
    "Cuda": np.float32,
    "CudaDouble": np.float64,
    "CudaHalf": np.float16,
    "CudaLong": np.int64,
    "CudaInt": np.int32,
    "CudaByte": np.uint8,
}
_TENSOR_RE = re.compile(r"^torch\.(\w+?)Tensor$")
_STORAGE_RE = re.compile(r"^torch\.(\w+?)Storage$")
# writer side: numpy dtype -> torch class stem
_DTYPE_TO_STEM = {
    np.dtype(np.float64): "Double",
    np.dtype(np.float32): "Float",
    np.dtype(np.float16): "Half",
    np.dtype(np.int64): "Long",
    np.dtype(np.int32): "Int",
    np.dtype(np.int16): "Short",
    np.dtype(np.int8): "Char",
    np.dtype(np.uint8): "Byte",
}


class TorchObject:
    """A deserialized torch class instance that is not a tensor/storage
    (e.g. an nn.Sequential). ``fields`` is the instance's Lua table."""

    def __init__(self, torch_type: str, fields: Optional[Dict] = None,
                 version: int = 1):
        self.torch_type = torch_type
        self.fields = {} if fields is None else fields
        self.version = version

    def __getitem__(self, k):
        return self.fields[k]

    def get(self, k, default=None):
        return self.fields.get(k, default)

    def __contains__(self, k):
        return k in self.fields

    def __repr__(self):
        return f"TorchObject({self.torch_type!r}, {list(self.fields)})"


class TorchFunction:
    """Opaque serialized Lua function (bytecode is kept, not executed)."""

    def __init__(self, dumped: bytes, upvalues):
        self.dumped = dumped
        self.upvalues = upvalues


class _Buffered:
    """Chunked byte source shared by the binary and ascii decoders."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.buf = b""
        self.pos = 0

    def _fill(self, n: int) -> None:
        need = n - (len(self.buf) - self.pos)
        if need > 0:
            chunk = self.f.read(max(need, 1 << 20))
            self.buf = self.buf[self.pos :] + chunk
            self.pos = 0
            if len(self.buf) < n:
                raise EOFError("truncated .t7 stream")

    def take(self, n: int) -> bytes:
        self._fill(n)
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def peek1(self) -> bytes:
        try:
            self._fill(1)
        except EOFError:
            return b""
        return self.buf[self.pos : self.pos + 1]

    def token(self) -> bytes:
        """Next whitespace-delimited token (ascii mode)."""
        while True:
            c = self.peek1()
            if c == b"":
                raise EOFError("truncated .t7 stream")
            if not c.isspace():
                break
            self.pos += 1
        start = self.pos
        while True:
            if self.pos >= len(self.buf):
                chunk = self.f.read(1 << 20)
                if not chunk:  # EOF terminates the final token
                    return self.buf[start : self.pos]
                self.buf = self.buf[start:] + chunk
                self.pos -= start
                start = 0
            if self.buf[self.pos : self.pos + 1].isspace():
                return self.buf[start : self.pos]
            self.pos += 1

    def tokens(self, n: int) -> list:
        """n whitespace-delimited tokens, scanned in bulk (storage
        payloads of ascii blobs run to 10^8 elements — a per-byte loop
        would take minutes)."""
        if n <= 16:  # tensor headers: skip the bulk-scan machinery
            return [self.token() for _ in range(n)]
        out: list = []
        at_eof = False
        while len(out) < n:
            rest = self.buf[self.pos :]
            matches = re.findall(rb"\S+", rest)
            # the final match may be a partial token cut by the buffer
            # edge — only trust it once the file is exhausted
            if matches and not at_eof and not rest[len(rest) - 1 :].isspace():
                matches.pop()
            take = min(len(matches), n - len(out))
            if take:
                out.extend(matches[:take])
                # advance past the take-th token (they are in order)
                idx = self.pos
                for t in matches[:take]:
                    idx = self.buf.index(t, idx) + len(t)
                self.pos = idx
                continue
            chunk = self.f.read(1 << 20)
            if not chunk:
                if at_eof:
                    raise EOFError("truncated .t7 stream")
                at_eof = True
                continue
            self.buf = self.buf[self.pos :] + chunk
            self.pos = 0
        return out


class _Reader:
    def __init__(self, f: BinaryIO, ascii_mode: bool):
        self.b = _Buffered(f)
        self.ascii = ascii_mode
        self.memo: Dict[int, Any] = {}

    # scalars ---------------------------------------------------------
    def read_int(self) -> int:
        if self.ascii:
            return int(self.b.token())
        return struct.unpack("<i", self.b.take(4))[0]

    def read_long(self) -> int:
        if self.ascii:
            return int(self.b.token())
        return struct.unpack("<q", self.b.take(8))[0]

    def read_double(self) -> float:
        if self.ascii:
            return float(self.b.token())
        return struct.unpack("<d", self.b.take(8))[0]

    def read_string(self) -> bytes:
        n = self.read_int()
        if self.ascii:
            self.b.take(1)  # the newline terminating the size token
            s = self.b.take(n)
        else:
            s = self.b.take(n)
        return s

    def read_long_array(self, n: int) -> np.ndarray:
        if self.ascii:
            return np.array(self.b.tokens(n), np.int64) if n else np.empty(0, np.int64)
        return np.frombuffer(self.b.take(8 * n), "<i8").copy()

    def read_elements(self, n: int, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        if self.ascii:
            if not n:
                return np.empty(0, dtype)
            toks = self.b.tokens(n)
            # integer storages parse exactly — a float64 intermediate
            # silently rounds int64 values above 2^53
            if dtype.kind in "iu":
                return np.array(toks, dtype)
            return np.array(toks, np.float64).astype(dtype)
        return np.frombuffer(
            self.b.take(int(n) * dtype.itemsize), dtype.newbyteorder("<")
        ).astype(dtype, copy=True)

    # objects ---------------------------------------------------------
    def read_object(self) -> Any:
        tag = self.read_int()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            return self.read_double()
        if tag == TYPE_STRING:
            return self.read_string()
        if tag == TYPE_BOOLEAN:
            return bool(self.read_int())
        if tag == TYPE_TABLE:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            out: Dict = {}
            self.memo[idx] = out  # register BEFORE recursing (cycles)
            npairs = self.read_int()
            for _ in range(npairs):
                k = self.read_object()
                v = self.read_object()
                out[_table_key(k)] = v
            return out
        if tag == TYPE_TORCH:
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            ver = self.read_string()
            m = re.match(rb"^V (\d+)$", ver)
            if m:
                version = int(m.group(1))
                cls = self.read_string().decode("ascii")
            else:
                version = 0
                cls = ver.decode("ascii")
            mt = _TENSOR_RE.match(cls)
            if mt and mt.group(1) in _ELEMENT_DTYPES:
                return self._read_tensor(idx, _ELEMENT_DTYPES[mt.group(1)])
            ms = _STORAGE_RE.match(cls)
            if ms and ms.group(1) in _ELEMENT_DTYPES:
                return self._read_storage(idx, _ELEMENT_DTYPES[ms.group(1)])
            obj = TorchObject(cls, version=version)
            self.memo[idx] = obj
            fields = self.read_object()
            if isinstance(fields, dict):
                obj.fields = fields
            else:  # classes with custom :write() we don't model
                obj.fields = {"__payload__": fields}
            return obj
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION, TYPE_LEGACY_RECUR_FUNCTION):
            idx = self.read_int()
            if idx in self.memo:
                return self.memo[idx]
            dumped = self.read_string()
            fn = TorchFunction(dumped, None)
            self.memo[idx] = fn
            fn.upvalues = self.read_object()
            return fn
        raise ValueError(f"unknown .t7 type tag {tag}")

    def _read_tensor(self, idx: int, dtype) -> np.ndarray:
        ndim = self.read_int()
        size = self.read_long_array(ndim)
        stride = self.read_long_array(ndim)
        offset = self.read_long() - 1  # torch offsets are 1-based
        placeholder = np.empty(0, dtype)
        self.memo[idx] = placeholder
        storage = self.read_object()
        if ndim == 0:
            # torch.Tensor() — the cleared/empty tensor ubiquitous in
            # clearState'd checkpoints: NO elements. np.empty(()) would
            # be a 0-d array holding one uninitialized value.
            arr = np.empty((0,), dtype)
        elif storage is None or int(np.prod(size)) == 0:
            arr = np.empty(tuple(int(s) for s in size), dtype)
        else:
            arr = np.lib.stride_tricks.as_strided(
                storage[offset:],
                shape=tuple(int(s) for s in size),
                strides=tuple(int(s) * storage.itemsize for s in stride),
            ).copy()
        # a tensor re-referenced later in the stream gets the real array
        self.memo[idx] = arr
        return arr

    def _read_storage(self, idx: int, dtype) -> np.ndarray:
        n = self.read_long()
        arr = self.read_elements(n, dtype)
        self.memo[idx] = arr
        return arr


def _table_key(k):
    if isinstance(k, float) and k.is_integer():
        return int(k)
    if isinstance(k, bytes):
        try:
            return k.decode("utf-8")
        except UnicodeDecodeError:
            return k
    return k


def _listify(obj, seen: Optional[dict] = None):
    """Convert pure-array Lua tables ({1..n} keys) to Python lists and
    decode byte strings, preserving shared references; cycles keep
    their dict form."""
    if seen is None:
        seen = {}
    oid = id(obj)
    if oid in seen:
        return seen[oid]
    if isinstance(obj, bytes):
        try:
            return obj.decode("utf-8")
        except UnicodeDecodeError:
            return obj
    if isinstance(obj, dict):
        keys = list(obj)
        is_array = keys and all(isinstance(k, int) for k in keys) and sorted(
            keys
        ) == list(range(1, len(keys) + 1))
        out: Any = [] if is_array else {}
        seen[oid] = out
        if is_array:
            out.extend(_listify(obj[i], seen) for i in range(1, len(keys) + 1))
        else:
            for k, v in obj.items():
                out[k] = _listify(v, seen)
        return out
    if isinstance(obj, TorchObject):
        seen[oid] = obj
        obj.fields = _listify(obj.fields, seen)
        return obj
    return obj


def sniff_ascii(path: str) -> bool:
    """Binary files start with int32 tag in [0, 8]; ascii files start
    with that tag as text. A leading ascii digit + newline within the
    first few bytes is the reliable discriminator."""
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) < 4:
        return True
    tag = struct.unpack("<i", head)[0]
    if 0 <= tag <= 8:
        return False
    return head[:1].isdigit()


def load(path: str, ascii_mode: Optional[bool] = None, listify: bool = True):
    """Read one torch.save'd object from ``path``."""
    if ascii_mode is None:
        ascii_mode = sniff_ascii(path)
    with open(path, "rb") as f:
        obj = _Reader(f, ascii_mode).read_object()
    return _listify(obj) if listify else obj


def loads(data: bytes, ascii_mode: bool = False, listify: bool = True):
    import io

    obj = _Reader(io.BytesIO(data), ascii_mode).read_object()
    return _listify(obj) if listify else obj


# ---------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------


class _Writer:
    def __init__(self, f: BinaryIO, ascii_mode: bool):
        self.f = f
        self.ascii = ascii_mode
        self.memo: Dict[int, int] = {}
        self.next_index = 1

    def write_int(self, v: int):
        if self.ascii:
            self.f.write(b"%d\n" % v)
        else:
            self.f.write(struct.pack("<i", v))

    def write_long(self, v: int):
        if self.ascii:
            self.f.write(b"%d\n" % v)
        else:
            self.f.write(struct.pack("<q", v))

    def write_double(self, v: float):
        if self.ascii:
            self.f.write(("%.17g\n" % v).encode())
        else:
            self.f.write(struct.pack("<d", v))

    def write_string(self, s: bytes):
        self.write_int(len(s))
        self.f.write(s)
        if self.ascii:
            self.f.write(b"\n")

    def write_elements(self, arr: np.ndarray):
        if self.ascii:
            fmt = "%d" if arr.dtype.kind in "iu" else "%.17g"
            self.f.write(
                (" ".join(fmt % v for v in arr.tolist()) + "\n").encode()
            )
        else:
            self.f.write(np.ascontiguousarray(arr).astype(
                arr.dtype.newbyteorder("<"), copy=False).tobytes())

    def _index_for(self, obj) -> Optional[int]:
        """Existing ref-index, or None after registering a new one."""
        oid = id(obj)
        if oid in self.memo:
            return self.memo[oid]
        self.memo[oid] = self.next_index
        self.next_index += 1
        return None

    def write_object(self, obj):
        if obj is None:
            self.write_int(TYPE_NIL)
        elif isinstance(obj, bool):
            self.write_int(TYPE_BOOLEAN)
            self.write_int(int(obj))
        elif isinstance(obj, (int, float, np.integer, np.floating)):
            self.write_int(TYPE_NUMBER)
            self.write_double(float(obj))
        elif isinstance(obj, str):
            self.write_int(TYPE_STRING)
            self.write_string(obj.encode("utf-8"))
        elif isinstance(obj, bytes):
            self.write_int(TYPE_STRING)
            self.write_string(obj)
        elif isinstance(obj, np.ndarray):
            self._write_tensor(obj)
        elif isinstance(obj, (dict, list, tuple)):
            self.write_int(TYPE_TABLE)
            idx = self._index_for(obj)
            if idx is not None:
                self.write_int(idx)
                return
            self.write_int(self.memo[id(obj)])
            if isinstance(obj, dict):
                pairs = list(obj.items())
            else:
                pairs = [(i + 1, v) for i, v in enumerate(obj)]
            self.write_int(len(pairs))
            for k, v in pairs:
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, TorchObject):
            self.write_int(TYPE_TORCH)
            idx = self._index_for(obj)
            if idx is not None:
                self.write_int(idx)
                return
            self.write_int(self.memo[id(obj)])
            self.write_string(b"V %d" % obj.version)
            self.write_string(obj.torch_type.encode("ascii"))
            self.write_object(obj.fields)
        else:
            raise TypeError(f"cannot serialize {type(obj)} to .t7")

    def _write_tensor(self, arr: np.ndarray):
        stem = _DTYPE_TO_STEM.get(arr.dtype)
        if stem is None:
            raise TypeError(f"no torch tensor class for dtype {arr.dtype}")
        if arr.ndim == 0:
            # torch's ndim-0 tensor is torch.Tensor() — EMPTY, not a
            # scalar: a 0-d numpy array's one value would not survive
            # the round trip
            raise TypeError(
                "0-d arrays have no torch.Tensor equivalent — reshape "
                "to (1,) or pass a Python number"
            )
        self.write_int(TYPE_TORCH)
        idx = self._index_for(arr)
        if idx is not None:
            self.write_int(idx)
            return
        self.write_int(self.memo[id(arr)])
        self.write_string(b"V 1")
        self.write_string(f"torch.{stem}Tensor".encode())
        arr_c = np.ascontiguousarray(arr)
        self.write_int(arr.ndim)
        sizes = arr_c.shape
        strides = [int(s // arr_c.itemsize) for s in arr_c.strides]
        if arr.ndim:
            for s in sizes:
                self.write_long(s)
            for s in strides:
                self.write_long(s)
        self.write_long(1)  # storageOffset (1-based)
        # storage object (fresh per tensor; tensors sharing numpy bases
        # serialize as independent storages)
        self.write_int(TYPE_TORCH)
        self.write_int(self.next_index)
        self.next_index += 1
        self.write_string(b"V 1")
        self.write_string(f"torch.{stem}Storage".encode())
        self.write_long(arr_c.size)
        self.write_elements(arr_c.reshape(-1))


def save(path: str, obj, ascii_mode: bool = False):
    """torch.save-compatible serialization of ``obj`` to ``path``."""
    with open(path, "wb") as f:
        _Writer(f, ascii_mode).write_object(obj)
