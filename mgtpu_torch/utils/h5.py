"""HDF5 files without h5py: the port's own writer and reader for the
subset its dumps use, with numpy and the standard library only.

The test pass's ``testOutput_<epoch>.h5`` holds one dataset a stored
output; the saliency harness's ``testOutput.h5`` a group ``id%05d`` a
kept sample, with datasets ``points``, ``saliency``, ``input`` and
(under ``-saliencyDumpStack 1``) ``output``. So the subset is:

- superblock version 0, 8-byte offsets and lengths, no user block;
- version 1 object headers (continuation blocks are followed);
- symbol-table groups: a v1 B-tree of group nodes (any depth), a local
  heap of names and symbol-table nodes;
- C-order datasets of any rank (0 included) in contiguous layout
  (layout message version 3);
- little-endian IEEE f32 and f64, and signed or unsigned 8-64-bit
  integers.

That is what h5py 3.14 (HDF5 1.14) writes by default, so h5py reads the
files written here and this reader reads the dumps h5py writes. The
reader skips the messages it does not need (fill values, modification
times, attributes, comments, NIL) and raises `FormatError` on anything
outside the subset (a chunked, compact or filtered layout, external
storage, a shared or committed datatype, a new-style group, a soft link,
another datatype): it never guesses.

The writer streams. ``create_dataset`` writes the dataset's object
header and its bytes at the end of the file at once, so a dump is never
built in memory; the group indexes (heaps, symbol-table nodes, B-trees),
the groups' object headers and the superblock's end-of-file address are
written when the file is closed. Its symbol-table nodes hold up to
2 x 4 names and its B-tree nodes up to 2 x 16 children, HDF5's default
K values, which the superblock records.

    with File(path, "w") as f:
        f.create_dataset("id00001/points", data=points)   # makes id00001
    with File(path, "r") as f:
        for gid in f.keys():
            points = np.asarray(f[gid]["points"])
"""

from __future__ import annotations

import os
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
FREE_NULL = 1  # a local heap's end of the free list (HDF5's H5HL_FREE_NULL)
LEAF_K, NODE_K = 4, 16  # symbol-table node and group B-tree K (HDF5's defaults)
SUPERBLOCK_SIZE = 96  # version 0 with 8-byte offsets: 56 bytes + the root's entry
ENTRY_SIZE = 40  # a symbol-table entry
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + 2 * NODE_K * 8 + (2 * NODE_K + 1) * 8

# object header message types
NIL, DATASPACE, DATATYPE, FILL_OLD, FILL = 0x0, 0x1, 0x3, 0x4, 0x5
LAYOUT, ATTRIBUTE, COMMENT, MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME = (
    0x8, 0xC, 0xD, 0xE, 0x10, 0x11, 0x12)
ATTRIBUTE_INFO, REFCOUNT = 0x15, 0x16
SKIPPED = {NIL, FILL_OLD, FILL, ATTRIBUTE, COMMENT, MTIME_OLD, MTIME, ATTRIBUTE_INFO, REFCOUNT}
NAMES = {0x2: "link info (a new-style group)", 0x6: "link (a new-style group)",
         0x7: "external data files", 0xA: "group info (a new-style group)",
         0xB: "filter pipeline (a filtered dataset)"}

# IEEE floats: size -> (bit offset, precision, exponent location, exponent
# size, mantissa location, mantissa size, exponent bias)
FLOATS = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}


class FormatError(ValueError):
    """The file is not HDF5, or uses a part of the format outside the
    subset this module reads."""


# ------------------------------------------------------------------ types

def _datatype_message(dtype: np.dtype) -> bytes:
    """The datatype message (version 1) of a supported numpy dtype."""
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        bits = 0x08 if dtype.kind == "i" else 0x00  # little-endian, zero padding
        return struct.pack("<B3sIHH", 0x10, bytes([bits, 0, 0]), dtype.itemsize, 0,
                           8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in FLOATS:
        size = dtype.itemsize
        # little-endian, zero padding, implied msb, the sign at the top bit
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([0x20, 8 * size - 1, 0]), size,
                           *FLOATS[size])
    raise FormatError(f"dtype {dtype} is outside the subset (integers of 8-64 bits and "
                      "IEEE f32/f64)")


def _parse_datatype(data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | data[2] << 8 | data[3] << 16
    size, = struct.unpack_from("<I", data, 4)
    if version != 1:
        raise FormatError(f"datatype message version {version} is outside the subset (1)")
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", data, 8)
        if bits & ~0x08 or size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise FormatError(f"integer type (bit fields {bits:#x}, {size} bytes, offset "
                              f"{offset}, precision {precision}) is outside the subset "
                              "(little-endian, zero padding, full precision)")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1:  # floating point
        props = struct.unpack_from("<HHBBBBI", data, 8)
        if size not in FLOATS or bits != 0x20 | (8 * size - 1) << 8 or props != FLOATS[size]:
            raise FormatError(f"float type (bit fields {bits:#x}, {size} bytes, properties "
                              f"{props}) is outside the subset (little-endian IEEE f32/f64)")
        return np.dtype(f"<f{size}")
    raise FormatError(f"datatype class {cls} is outside the subset (integers and IEEE "
                      "f32/f64 only)")


def _dataspace_message(shape: tuple) -> bytes:
    """Version 1, with the maximum dimensions (equal to the dimensions)
    as h5py writes them; rank 0 is a scalar."""
    rank = len(shape)
    return struct.pack(f"<BBBB4x{2 * rank}Q", 1, rank, 1 if rank else 0, 0, *shape, *shape)


def _parse_dataspace(data: bytes) -> tuple:
    version, rank = data[0], data[1]
    if version != 1:
        raise FormatError(f"dataspace message version {version} is outside the subset (1)")
    return struct.unpack_from(f"<{rank}Q", data, 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    """One v1 object header message, its data padded to 8 bytes."""
    data = data + b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list) -> bytes:
    """A v1 object header: its 16-byte prefix, then the messages."""
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


# ----------------------------------------------------------------- reader

class Dataset:
    """A contiguous dataset of a file open for reading; ``np.asarray``
    reads it whole."""

    def __init__(self, file: File, name: str, shape: tuple, dtype: np.dtype, address: int):
        self.file, self.name = file, name
        self.shape, self.dtype, self._address = shape, dtype, address

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    def read(self) -> np.ndarray:
        if self.size == 0:
            return np.zeros(self.shape, self.dtype)
        f = self.file._handle()
        f.seek(self._address)
        out = np.fromfile(f, self.dtype, self.size)
        if out.size != self.size:
            raise FormatError(f"{self.name}: short read, {out.size} of {self.size} elements "
                              f"at {self._address} in {self.file.path}")
        return out.reshape(self.shape)

    def __array__(self, dtype=None, copy=None):
        out = self.read()
        return out if dtype is None else out.astype(dtype, copy=False)

    def __repr__(self) -> str:
        return f"<h5 dataset {self.name!r}: shape {self.shape}, dtype {self.dtype}>"


class Group:
    """A symbol-table group of a file open for reading: its members by
    name, in name order."""

    def __init__(self, file: File, name: str, links: dict):
        self.file, self.name, self._links = file, name, links

    def keys(self) -> list:
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"{path!r} is not in {self.name!r} of {self.file.path}")
            node = self.file._object(f"{node.name.rstrip('/')}/{part}", node._links[part])
        return node

    def __repr__(self) -> str:
        return f"<h5 group {self.name!r}: {len(self._links)} members>"


# ----------------------------------------------------------------- writer

class _NewGroup:
    """A group being written: member name -> _NewGroup, or a dataset's
    object header address."""

    def __init__(self):
        self.members: dict = {}


class File(Group):
    """An HDF5 file of the subset, open for reading (``mode="r"``) or
    for writing anew (``"w"``), as a context manager."""

    def __init__(self, path, mode: str = "r"):
        self.path, self.mode = os.fspath(path), mode
        if mode == "r":
            self._f = open(self.path, "rb")
            try:
                root = self._superblock()
                super().__init__(self, "/", self._group_links(root))
            except BaseException:
                self._f.close()
                raise
        elif mode == "w":
            self._f = open(self.path, "wb")
            self._f.write(b"\0" * SUPERBLOCK_SIZE)  # written at close
            self._eof = SUPERBLOCK_SIZE
            self._root = _NewGroup()
            self.file, self.name = self, "/"
        else:
            raise ValueError(f"mode {mode!r}: 'r' (read) or 'w' (write anew)")

    # -- both modes

    def _handle(self):
        if self._f.closed:
            raise ValueError(f"{self.path} is closed")
        return self._f

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._f.closed:
            return
        try:
            if self.mode == "w":
                self._finish()
        finally:
            self._f.close()

    def __getitem__(self, path: str):
        if self.mode == "w":
            raise ValueError(f"{self.path} is open for writing: reopen it with mode 'r'")
        return super().__getitem__(path)

    # -- reading

    def _read(self, address: int, n: int) -> bytes:
        f = self._handle()
        f.seek(address)
        data = f.read(n)
        if len(data) != n:
            raise FormatError(f"short read: {len(data)} of {n} bytes at {address} in "
                              f"{self.path}")
        return data

    def _superblock(self) -> int:
        """Check the superblock; the root group's object header address."""
        head = self._read(0, 24)
        if head[:8] != SIGNATURE:
            raise FormatError(f"{self.path} is not an HDF5 file (or has a user block)")
        version, offsets, lengths = head[8], head[13], head[14]
        if version != 0:
            raise FormatError(f"superblock version {version} is outside the subset (0)")
        if (offsets, lengths) != (8, 8):
            raise FormatError(f"{offsets}-byte offsets and {lengths}-byte lengths are "
                              "outside the subset (8 and 8)")
        # the base, free-space, end-of-file and file-information addresses,
        # then the root group's entry: its name's offset and object header
        base, *_, header = struct.unpack("<6Q", self._read(24, 48))
        if base:
            raise FormatError(f"base address {base} is outside the subset (0)")
        return header

    def _messages(self, address: int) -> list:
        """The (type, data) of a v1 object header's messages, continuation
        blocks followed."""
        prefix = self._read(address, 16)
        if prefix[:4] == b"OHDR":
            raise FormatError(f"version 2 object header at {address} is outside the subset")
        if prefix[0] != 1:
            raise FormatError(f"object header version {prefix[0]} at {address}")
        size, = struct.unpack_from("<I", prefix, 8)
        blocks, out = [(address + 16, size)], []
        while blocks:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mflags & 0x02:
                    raise FormatError(f"a shared message (type {mtype:#x}) at {address} is "
                                      "outside the subset")
                out.append((mtype, data))
        return out

    def _object(self, name: str, address: int):
        found = {}
        for mtype, data in self._messages(address):
            if mtype in SKIPPED:
                continue
            if mtype not in (DATASPACE, DATATYPE, LAYOUT, SYMBOL_TABLE):
                what = NAMES.get(mtype, "unknown")
                raise FormatError(f"{name}: message type {mtype:#06x} ({what}) is outside the "
                                  "subset")
            found[mtype] = data
        if SYMBOL_TABLE in found:
            return Group(self, name, self._group_links(address, found[SYMBOL_TABLE]))
        if not all(t in found for t in (DATASPACE, DATATYPE, LAYOUT)):
            raise FormatError(f"{name}: neither a symbol-table group nor a dataset")
        shape = _parse_dataspace(found[DATASPACE])
        dtype = _parse_datatype(found[DATATYPE])
        layout = found[LAYOUT]
        if layout[0] != 3:
            raise FormatError(f"{name}: layout message version {layout[0]} is outside the "
                              "subset (3)")
        if layout[1] != 1:
            kind = {0: "compact", 2: "chunked"}.get(layout[1], f"class {layout[1]}")
            raise FormatError(f"{name}: {kind} layout is outside the subset (contiguous only)")
        data_address, size = struct.unpack_from("<QQ", layout, 2)
        ds = Dataset(self, name, tuple(shape), dtype, data_address)
        if ds.nbytes and (data_address == UNDEF or size != ds.nbytes):
            raise FormatError(f"{name}: {size} bytes stored at {data_address:#x} for "
                              f"{ds.nbytes} bytes of data (no storage written?)")
        return ds

    def _group_links(self, address: int, table: bytes | None = None) -> dict:
        """A group's members, name -> object header address, in name
        order."""
        if table is None:
            msgs = [d for t, d in self._messages(address) if t == SYMBOL_TABLE]
            if not msgs:
                raise FormatError(f"the root group at {address} has no symbol table (a "
                                  "new-style group is outside the subset)")
            table = msgs[0]
        btree, heap = struct.unpack_from("<QQ", table)
        head = self._read(heap, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise FormatError(f"no version 0 local heap at {heap}")
        size, _free, data_address = struct.unpack_from("<QQQ", head, 8)
        names = self._read(data_address, size)
        links = {}
        self._walk(btree, names, links)
        return links

    def _walk(self, address: int, names: bytes, links: dict) -> None:
        head = self._read(address, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise FormatError(f"no group B-tree node at {address}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = struct.unpack(f"<{2 * used + 1}Q", self._read(address + 24, 8 * (2 * used + 1)))
        for child in body[1::2]:
            if level:
                self._walk(child, names, links)
            else:
                self._symbols(child, names, links)

    def _symbols(self, address: int, names: bytes, links: dict) -> None:
        head = self._read(address, 8)
        if head[:4] != b"SNOD" or head[4] != 1:
            raise FormatError(f"no symbol-table node at {address}")
        count, = struct.unpack_from("<H", head, 6)
        body = self._read(address + 8, count * ENTRY_SIZE)
        for i in range(count):
            offset, header, cache = struct.unpack_from("<QQI", body, i * ENTRY_SIZE)
            end = names.index(b"\0", offset)
            name = names[offset:end].decode()
            if cache == 2:
                raise FormatError(f"{name}: a soft link is outside the subset")
            links[name] = header

    # -- writing

    def _append(self, data) -> int:
        """Write ``data`` at the end of the file, 8-byte aligned; its
        address."""
        pad = -self._eof % 8
        if pad:
            self._f.write(b"\0" * pad)
            self._eof += pad
        address = self._eof
        self._f.write(data)
        self._eof += memoryview(data).nbytes
        return address

    def create_dataset(self, name: str, data) -> None:
        """Write ``data`` as dataset ``name`` (intermediate groups made as
        needed): its object header and bytes go to the file now."""
        if self.mode != "w":
            raise ValueError(f"{self.path} is open for reading")
        arr = np.asarray(data)
        dtype = _datatype_message(arr.dtype)
        arr = np.asarray(arr, arr.dtype.newbyteorder("<"), order="C")  # keeps rank 0
        size = arr.nbytes
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError(f"dataset name {name!r}")
        group = self._root
        for part in parts[:-1]:
            node = group.members.setdefault(part, _NewGroup())
            if not isinstance(node, _NewGroup):
                raise ValueError(f"unable to create {name!r}: {part!r} is a dataset")
            group = node
        if parts[-1] in group.members:
            raise ValueError(f"unable to create dataset {name!r}: name already exists")

        def header(data_address):
            return _object_header([
                _message(DATASPACE, _dataspace_message(arr.shape)),
                _message(DATATYPE, dtype, flags=1),  # constant
                # fill value version 2: allocated late, written if set, the default
                _message(FILL, struct.pack("<4BI", 2, 2, 2, 1, 0), flags=1),
                _message(LAYOUT, struct.pack("<BBQQ", 3, 1, data_address, size)),
            ])

        # the bytes follow the header, which starts at the next 8-byte boundary
        data_address = self._eof + -self._eof % 8 + len(header(0)) if size else UNDEF
        group.members[parts[-1]] = self._append(header(data_address))
        if size:
            self._f.write(arr.data)
            self._eof += size
        self._f.flush()

    def _write_group(self, group: _NewGroup) -> tuple:
        """Write a group's children, heap, symbol-table nodes, B-tree and
        object header (children first); (its header, B-tree and heap
        addresses)."""
        names = sorted(group.members, key=str.encode)  # HDF5 orders names by strcmp
        entries = []
        for name in names:
            node = group.members[name]
            if isinstance(node, _NewGroup):
                entries.append((name, *self._write_group(node)))
            else:
                entries.append((name, node, None, None))
        heap, offsets = bytearray(8), {}  # offset 0: the empty name
        for name in names:
            offsets[name] = len(heap)
            raw = name.encode() + b"\0"
            heap += raw + b"\0" * (-len(raw) % 8)
        heap_address = self._append(struct.pack("<4s4xQQQ", b"HEAP", len(heap), FREE_NULL,
                                                self._eof + -self._eof % 8 + 32) + heap)
        # symbol-table nodes of up to 2 x LEAF_K entries, then B-tree levels
        # of up to 2 x NODE_K children: (address, first key, last name)
        level, lo = [], 0
        for i in range(0, len(entries), 2 * LEAF_K):
            chunk = entries[i:i + 2 * LEAF_K]
            body = b"".join(
                struct.pack("<QQI4x", offsets[n], h, 0) + b"\0" * 16 if b is None
                else struct.pack("<QQI4xQQ", offsets[n], h, 1, b, hp) for n, h, b, hp in chunk)
            body += b"\0" * (SNOD_SIZE - 8 - len(body))
            address = self._append(struct.pack("<4sBxH", b"SNOD", 1, len(chunk)) + body)
            level.append((address, lo, offsets[chunk[-1][0]]))
            lo = offsets[chunk[-1][0]]
        depth = 0
        while True:
            nodes = [level[i:i + 2 * NODE_K] for i in range(0, len(level), 2 * NODE_K)] or [[]]
            first = self._eof + -self._eof % 8
            above = []
            for j, children in enumerate(nodes):
                left = first + (j - 1) * TREE_SIZE if j else UNDEF
                right = first + (j + 1) * TREE_SIZE if j + 1 < len(nodes) else UNDEF
                keys = [children[0][1] if children else 0]
                for address, _, last in children:
                    keys += [address, last]
                body = struct.pack(f"<{len(keys)}Q", *keys)
                body += b"\0" * (TREE_SIZE - 24 - len(body))
                address = self._append(struct.pack("<4sBBHQQ", b"TREE", 0, depth, len(children),
                                                   left, right) + body)
                assert address == first + j * TREE_SIZE
                above.append((address, keys[0], keys[-1]))
            if len(above) == 1:
                btree = above[0][0]
                break
            level, depth = above, depth + 1
        header = self._append(_object_header([_message(SYMBOL_TABLE,
                                                       struct.pack("<QQ", btree, heap_address))]))
        return header, btree, heap_address

    def _finish(self) -> None:
        header, btree, heap = self._write_group(self._root)
        eof = self._eof
        self._f.seek(0)
        self._f.write(SIGNATURE + struct.pack(
            "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0, 0, UNDEF, eof, UNDEF)
            + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap))
        self._f.flush()
