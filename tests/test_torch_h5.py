"""The port's HDF5 layer (`mgtpu_torch/utils/h5.py`) against h5py, both
ways: files the port writes read by h5py, files h5py writes read by the
port, with the same names, shapes, dtypes and bytes; the saliency
dump's shape of 1,000 ``id%05d`` groups (a group B-tree of more than one
level on either side); a dataset over 64 MB written as it comes; and the
files outside the subset that the reader refuses."""

import os
import struct
import tracemalloc

import h5py
import numpy as np
import pytest

from mgtpu_torch.utils import h5

DTYPES = ["<f4", "<f8", "<i1", "<i2", "<i4", "<i8", "<u1", "<u2", "<u4", "<u8"]
SHAPES = {0: (), 1: (7,), 2: (3, 5), 3: (2, 3, 4), 4: (2, 3, 2, 5)}


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def _arrays(dtype, rank):
    """A dataset at the root and two in nested groups (an intermediate
    group made by the name)."""
    return {"x": _array(dtype, SHAPES[rank], 0),
            "id00001/points": _array(dtype, SHAPES[rank], 1),
            "id00001/sub/saliency": _array(dtype, SHAPES[rank], 2)}


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def _h5py_datasets(f) -> dict:
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                 if isinstance(obj, h5py.Dataset) else None)
    return out


def _port_datasets(group, prefix="") -> dict:
    out = {}
    for name in group.keys():
        obj = group[name]
        if isinstance(obj, h5.Group):
            out.update(_port_datasets(obj, f"{prefix}{name}/"))
        else:
            out[prefix + name] = np.asarray(obj)
    return out


@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_h5py_reads_what_the_port_writes(dtype, rank, tmp_path):
    arrays = _arrays(dtype, rank)
    with h5.File(tmp_path / "port.h5", "w") as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a)
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert list(f.keys()) == ["id00001", "x"]
        assert list(f["id00001"].keys()) == ["points", "sub"]
        got = _h5py_datasets(f)
        assert sorted(got) == sorted(arrays)
        for name, a in arrays.items():
            assert f[name].shape == a.shape and f[name].dtype == a.dtype
            _same(np.asarray(got[name]), a)


@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_port_reads_what_h5py_writes(dtype, rank, tmp_path):
    arrays = _arrays(dtype, rank)
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        for name, a in arrays.items():
            f.create_dataset(name, data=a)
    with h5.File(tmp_path / "h5py.h5", "r") as f:
        assert f.keys() == ["id00001", "x"]
        assert f["id00001"].keys() == ["points", "sub"]
        got = _port_datasets(f)
        assert sorted(got) == sorted(arrays)
        for name, a in arrays.items():
            ds = f[name]
            assert ds.shape == a.shape and ds.dtype == a.dtype
            _same(got[name], a)


def _dump(n):
    """A saliency dump's groups, small: id%05d/{points,saliency,input,
    output} of 1-based sample indices."""
    rng = np.random.default_rng(3)
    return {f"id{i:05d}": {"points": (rng.random((7, 4, 4, 1)) > 0.8).astype(np.float32),
                           "saliency": rng.random((7, 4, 4, 1), dtype=np.float32),
                           "input": rng.standard_normal((4, 4, 1), dtype=np.float32),
                           "output": rng.random((3, 4, 4, 1), dtype=np.float32)}
            for i in range(1, n + 1)}


def _root_btree_level(path) -> int:
    """The level of the root group's B-tree root node (0: one node of
    symbol-table nodes), from the superblock's root entry (version 0)."""
    with open(path, "rb") as f:
        f.seek(80)  # the root entry's scratch pad: B-tree, heap
        btree, = struct.unpack("<Q", f.read(8))
        f.seek(btree)
        node = f.read(8)
    assert node[:4] == b"TREE"
    return node[5]


def test_a_1000_group_dump_both_ways(tmp_path):
    """1,000 groups (a saliency dump of translation_3's test split): past
    32 symbol-table nodes, so each side's root group B-tree has two
    levels; each side reads the other's, every group and dataset, and
    h5py finds each group by name in the port's tree."""
    dump = _dump(1000)
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        for gid, arrays in dump.items():
            for name, a in arrays.items():
                f.create_dataset(f"{gid}/{name}", data=a)
    with h5.File(tmp_path / "port.h5", "w") as f:
        for gid, arrays in dump.items():
            for name, a in arrays.items():
                f.create_dataset(f"{gid}/{name}", data=a)
    assert _root_btree_level(tmp_path / "h5py.h5") >= 1
    assert _root_btree_level(tmp_path / "port.h5") >= 1
    with h5.File(tmp_path / "h5py.h5", "r") as f:
        assert f.keys() == sorted(dump)
        for gid, arrays in dump.items():
            assert f[gid].keys() == sorted(arrays)
            for name, a in arrays.items():
                _same(np.asarray(f[gid][name]), a)
    with h5py.File(tmp_path / "port.h5", "r") as f:
        assert list(f.keys()) == sorted(dump)
        for gid, arrays in dump.items():
            assert list(f[gid].keys()) == sorted(arrays)
            for name, a in arrays.items():
                _same(f[f"{gid}/{name}"][()], a)


def test_a_dataset_over_64_mb_goes_to_disk_as_it_is_created(tmp_path):
    """The writer's bytes are on disk when create_dataset returns, and it
    allocates no copy of a contiguous array; h5py reads it back."""
    big = np.arange(70 * 2**20 // 4, dtype=np.float32).reshape(-1, 64, 64)
    assert big.nbytes > 64 * 2**20
    path = tmp_path / "big.h5"
    with h5.File(path, "w") as f:
        f.create_dataset("small", data=np.ones(3, np.int16))
        tracemalloc.start()
        try:
            f.create_dataset("id00001/output", data=big)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert os.path.getsize(path) >= big.nbytes
        assert peak < 2**20, peak
    with h5py.File(path, "r") as f:
        got = f["id00001/output"][()]
        assert got.shape == big.shape and np.array_equal(got, big)
    with h5.File(path, "r") as f:
        assert np.array_equal(np.asarray(f["id00001"]["output"]), big)


@pytest.mark.parametrize("kind", ["chunked", "gzip", "shuffle", "compact", "bool", "float16",
                                  "string", "compound", "big-endian", "soft-link"])
def test_the_reader_refuses_what_is_outside_the_subset(kind, tmp_path):
    path = tmp_path / f"{kind}.h5"
    data = np.arange(64, dtype=np.float32).reshape(8, 8)
    with h5py.File(path, "w") as f:
        f.create_dataset("ok", data=data)
        if kind == "chunked":
            f.create_dataset("x", data=data, chunks=(4, 4))
        elif kind in ("gzip", "shuffle"):
            f.create_dataset("x", data=data, chunks=(4, 4), compression="gzip",
                             shuffle=kind == "shuffle")
        elif kind == "compact":
            space = h5py.h5s.create_simple(data.shape)
            plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            plist.set_layout(h5py.h5d.COMPACT)
            h5py.h5d.create(f.id, b"x", h5py.h5t.NATIVE_FLOAT, space, plist)
        elif kind == "bool":
            f.create_dataset("x", data=data > 3)
        elif kind == "float16":
            f.create_dataset("x", data=data.astype(np.float16))
        elif kind == "string":
            f.create_dataset("x", data=np.array([b"abc", b"de"]))
        elif kind == "compound":
            f.create_dataset("x", data=np.zeros(3, [("a", "<f4"), ("b", "<i2")]))
        elif kind == "big-endian":
            f.create_dataset("x", data=data.astype(">f4"))
        elif kind == "soft-link":
            f["x"] = h5py.SoftLink("/ok")
    if kind == "soft-link":
        with pytest.raises(h5.FormatError, match="outside the subset"):
            h5.File(path, "r")
        return
    with h5.File(path, "r") as f:
        assert np.array_equal(np.asarray(f["ok"]), data)
        with pytest.raises(h5.FormatError, match="outside the subset"):
            f["x"]


@pytest.mark.parametrize("dtype", ["bool", "<f2", "<c8", "S3", ">f4"])
def test_the_writer_takes_only_the_subset(dtype, tmp_path):
    """Types outside the subset are refused; a big-endian array is written
    little-endian, the same values."""
    a = np.zeros(4, dtype)
    with h5.File(tmp_path / "w.h5", "w") as f:
        if dtype == ">f4":
            f.create_dataset("x", data=np.arange(4, dtype=dtype))
        else:
            with pytest.raises(h5.FormatError, match="outside the subset"):
                f.create_dataset("x", data=a)
    if dtype == ">f4":
        with h5py.File(tmp_path / "w.h5", "r") as f:
            assert f["x"].dtype == np.dtype("<f4") and list(f["x"][()]) == [0, 1, 2, 3]


def test_names_and_modes(tmp_path):
    path = tmp_path / "n.h5"
    with h5.File(path, "w") as f:
        f.create_dataset("/id00002/input", data=np.ones(2))
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("id00002/input", data=np.ones(2))
        with pytest.raises(ValueError, match="is a dataset"):
            f.create_dataset("id00002/input/x", data=np.ones(2))
        with pytest.raises(ValueError, match="open for writing"):
            f["id00002"]
    with h5.File(path, "r") as f:
        assert "id00002/input" in f and "id00003" not in f and f.keys() == ["id00002"]
        with pytest.raises(KeyError):
            f["id00002/output"]
        with pytest.raises(ValueError, match="open for reading"):
            f.create_dataset("y", data=np.ones(2))
    with pytest.raises(ValueError, match="mode"):
        h5.File(path, "a")
    empty = tmp_path / "empty.h5"
    h5.File(empty, "w").close()
    with h5py.File(empty, "r") as f:
        assert list(f.keys()) == []
    (tmp_path / "not.h5").write_bytes(b"\0" * 128)
    with pytest.raises(h5.FormatError, match="not an HDF5 file"):
        h5.File(tmp_path / "not.h5", "r")


def test_a_cut_file_is_a_short_read(tmp_path):
    """h5py writes the metadata first and the data after it: a file cut
    inside the data opens, and reading the dataset raises."""
    path = tmp_path / "whole.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(1000, dtype=np.float64))
        offset = f["x"].id.get_offset()
    cut = tmp_path / "cut.h5"
    cut.write_bytes(path.read_bytes()[:offset + 4000])
    with h5.File(cut, "r") as f:
        assert f["x"].shape == (1000,)
        with pytest.raises(h5.FormatError, match="short read"):
            np.asarray(f["x"])
