"""The port's Torch7 reader and writer (`mgtpu_torch/utils/t7.py`) and its
t7 tools (`mgtpu_torch/tools/read_t7.py`, `import_t7_model.py`) against
the JAX package's (`mgtpu/utils/t7.py`, `tools/read_t7.py`,
`tools/import_t7_model.py`) on the same inputs.

- every reader/writer case of tests/test_t7.py (all types in both
  framings, refs and cycles, nn graphs, strides, legacy class names,
  CUDA storages, empty tensors, the 0-d refusal, int64, the golden
  bytes) run against the port's module;
- the port's writer writes the JAX writer's bytes, and each reads the
  other's;
- ``read_t7 --format cifar|mnist-task`` writes the JAX tool's npz
  arrays, which `mgtpu_torch.data` loads;
- one synthetic ``cifar/nmg`` model blob through both importers: wrapped
  in a DataParallelTable, and with a SpatialConvolutionMM weight and a
  legacy ``running_std``: bit-equal mgtpu-ckpt trees and metas, and the
  imported port model's f32 eval forward within 1e-5 of the scale of
  JAX's ``model.apply`` on the JAX import; a blob short of one module
  ("sequences disagree") and a dropped non-zero bias are refused by
  both.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import test_t7
from mgtpu.utils import t7 as jax_t7
from mgtpu_torch.utils import t7
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)

# the reader/writer cases of tests/test_t7.py, each run with the port's module
T7_CASES = [
    ("test_roundtrip_all_types", {"ascii_mode": False}),
    ("test_roundtrip_all_types", {"ascii_mode": True}),
    ("test_roundtrip_shared_refs_and_cycles", {"ascii_mode": False}),
    ("test_roundtrip_shared_refs_and_cycles", {"ascii_mode": True}),
    ("test_roundtrip_torch_object_nn_graph", {}),
    ("test_reader_nonstandard_strides", {}),
    ("test_legacy_class_name_without_version", {}),
    ("test_cuda_tensor_maps_to_f32", {}),
    ("test_writer_rejects_0d_array", {}),
    ("test_int64_exact_roundtrip", {"ascii_mode": False}),
    ("test_int64_exact_roundtrip", {"ascii_mode": True}),
    ("test_golden_binary_fixture", {}),
    ("test_golden_binary_noncontiguous_offset", {}),
    ("test_golden_ascii_fixture", {}),
    ("test_golden_nn_class_record", {}),
    ("test_writer_reproduces_golden_bytes", {}),
]


@pytest.mark.parametrize("case, kwargs", T7_CASES,
                         ids=[f"{c}-{'-'.join(map(str, k.values()))}" for c, k in T7_CASES])
def test_port_t7_passes_the_jax_cases(case, kwargs, tmp_path, monkeypatch):
    monkeypatch.setattr(test_t7, "t7", t7)
    getattr(test_t7, case)(tmp_path=tmp_path, **kwargs)


def test_empty_tensor_reads_as_zero_elements(tmp_path):
    """torch.Tensor() (ndim 0, nil storage) written by the port's writer
    reads back as an empty float32 array."""
    path = str(tmp_path / "empty.t7")
    with open(path, "wb") as f:
        w = t7._Writer(f, False)
        w.write_int(t7.TYPE_TORCH)
        w.write_int(1)
        w.write_string(b"V 1")
        w.write_string(b"torch.FloatTensor")
        w.write_int(0)
        w.write_long(1)
        w.write_object(None)
    for mod in (t7, jax_t7):
        out = mod.load(path)
        assert isinstance(out, np.ndarray) and out.shape == (0,) and out.dtype == np.float32


def _every_type():
    rng = np.random.default_rng(0)
    shared = {"x": 1.0}
    conv = t7.TorchObject("nn.SpatialConvolution", {
        "weight": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
        "nInputPlane": 3.0, "flag": True})
    obj = {
        "f64": rng.standard_normal((2, 3)), "f32": rng.standard_normal(5).astype(np.float32),
        "f16": rng.standard_normal(3).astype(np.float16),
        "i64": np.array([2**60 + 1, -7], np.int64), "i32": np.arange(4, dtype=np.int32),
        "i16": np.arange(3, dtype=np.int16), "i8": np.arange(3, dtype=np.int8),
        "u8": np.arange(3, dtype=np.uint8), "empty": np.empty((0,), np.float32),
        "num": 3.5, "str": "hello", "t": True, "f": False, "nil": None,
        "list": [1.0, 2.0, {"deep": "x"}], "a": shared, "b": shared, "conv": conv,
        "seq": t7.TorchObject("nn.Sequential", {"modules": [conv, conv]}),
    }
    obj["self"] = obj
    return obj


def _jax_objects(obj, seen=None):
    """The same object graph with the JAX module's TorchObject class."""
    seen = {} if seen is None else seen
    if id(obj) in seen:
        return seen[id(obj)]
    if isinstance(obj, t7.TorchObject):
        out = jax_t7.TorchObject(obj.torch_type, {})
        seen[id(obj)] = out
        out.fields.update({k: _jax_objects(v, seen) for k, v in obj.fields.items()})
        return out
    if isinstance(obj, dict):
        out = seen[id(obj)] = {}
        out.update({k: _jax_objects(v, seen) for k, v in obj.items()})
        return out
    if isinstance(obj, list):
        out = seen[id(obj)] = []
        out.extend(_jax_objects(v, seen) for v in obj)
        return out
    return obj


@pytest.mark.parametrize("ascii_mode", [False, True])
def test_writer_bytes_equal_the_jax_writer(tmp_path, ascii_mode):
    """One object of every type, shared refs, a cycle and nn classes: the
    two writers write the same bytes, and each reader reads the other's
    file to the same values."""
    obj = _every_type()
    ours, theirs = str(tmp_path / "port.t7"), str(tmp_path / "jax.t7")
    t7.save(ours, obj, ascii_mode=ascii_mode)
    jax_t7.save(theirs, _jax_objects(obj), ascii_mode=ascii_mode)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back, back_jax = t7.load(theirs), jax_t7.load(ours)
    assert back["self"] is back and back["a"] is back["b"]
    assert back["seq"]["modules"][0] is back["seq"]["modules"][1]
    assert isinstance(back["conv"], t7.TorchObject)
    for k in ("f64", "f32", "f16", "i64", "i32", "i16", "i8", "u8", "empty"):
        for got in (back[k], back_jax[k]):
            np.testing.assert_array_equal(got, obj[k])
            assert got.dtype == obj[k].dtype
    np.testing.assert_array_equal(back["conv"]["weight"], obj["conv"]["weight"])
    assert back["list"] == back_jax["list"] == [1.0, 2.0, {"deep": "x"}]
    assert (back["num"], back["str"], back["t"], back["f"], back["nil"]) == (
        3.5, "hello", True, False, None)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_npz_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_read_t7_cifar_matches_the_jax_tool(tmp_path, capsys):
    """--format cifar: the JAX tool's arrays; `mgtpu_torch.data` loads
    them; the inspect mode prints the JAX tool's lines."""
    import read_t7 as jax_read_t7

    from mgtpu_torch.data.cifar import build_cifar100_whitened
    from mgtpu_torch.tools import read_t7

    blob = str(tmp_path / "cifar100_whitened.t7")
    test_t7._fake_cifar_blob(blob)
    ref = jax_read_t7.convert_cifar(jax_t7.load(blob))
    out = str(tmp_path / "cifar100_whitened.npz")
    read_t7.main([blob, "--format", "cifar", "--to-npz", out])
    _assert_npz_equal(_npz(out), ref)
    opt = types.SimpleNamespace(data=str(tmp_path), imageSize=36, imageCrop=32,
                                colorspace="bgr", dataAug="default")
    loaders = build_cifar100_whitened(opt)
    assert loaders["train"].size() == 200
    x, y = loaders["test"].get_inputs(1, 4, 1)
    assert x.shape == (4, 32, 32, 3) and y.min() >= 0
    capsys.readouterr()
    read_t7.main([blob])
    ours = capsys.readouterr().out
    jax_read_t7.describe(jax_t7.load(blob), os.path.basename(blob))
    assert ours == capsys.readouterr().out and "trainData" in ours


def test_read_t7_mnist_task_and_generic_match_the_jax_tool(tmp_path):
    """--format mnist-task (val -> valid) and the generic dump: the JAX
    tool's arrays; `mgtpu_torch.data` loads the task with its three
    splits."""
    import read_t7 as jax_read_t7

    from mgtpu_torch.data.mnist import build_mnist_task
    from mgtpu_torch.tools import read_t7

    rng = np.random.default_rng(4)

    def split(n):
        return {"data": rng.random((n, 1, 64, 64)).astype(np.float32),
                "labels": rng.random((n, 10, 64, 64)).astype(np.float32)}

    blob = str(tmp_path / "mnist_segmentation.t7")
    t7.save(blob, {"train": split(6), "val": split(3), "test": split(3)})
    out = str(tmp_path / "mnist_segmentation.npz")
    read_t7.main([blob, "--format", "mnist-task", "--to-npz", out])
    _assert_npz_equal(_npz(out), jax_read_t7.convert_mnist_task(jax_t7.load(blob)))
    loaders = build_mnist_task(types.SimpleNamespace(data=str(tmp_path)), "mnist-seg")
    assert set(loaders) == {"train", "test", "eval"} and loaders["eval"].size() == 3
    generic = str(tmp_path / "generic.npz")
    read_t7.main([blob, "--to-npz", generic])
    _assert_npz_equal(_npz(generic), jax_read_t7.collect_tensors(jax_t7.load(blob)))


# --- the model importers --------------------------------------------------
NMG = dict(netType="cifar/nmg", dataset="cifar100-whitened", nLayer=1)


def _blob_modules(rng):
    """A model_<E>.t7-shaped module list for cifar/nmg nLayer 1 in the
    port's slot order (`import_t7_model.flatten_mg` of its JAX-layout
    tree), reference layouts, weights at the init's scale (so that the
    f32 forwards compare at a sane scale): conv (O,I,kH,kW) with a bias,
    BN weight/bias/running stats, Linear (O,I)."""
    from mgtpu_torch.models import create_model
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.tools.import_t7_model import flatten_mg
    from mgtpu_torch.utils.bridge import export_jax_tree

    params, stats = export_jax_tree(create_model(NetOpts(**NMG)))
    modules = []
    for kind, p, _ in flatten_mg(params, stats, []):
        if kind == "conv":
            kh, kw, ci, co = p["w"].shape
            w = rng.standard_normal((co, ci, kh, kw)) * np.sqrt(2.0 / (kh * kw * co))
            modules.append(t7.TorchObject("cudnn.SpatialConvolution", {
                "weight": w.astype(np.float32),
                "bias": (0.1 * rng.standard_normal(co)).astype(np.float32),
                "nInputPlane": float(ci), "nOutputPlane": float(co),
                "kH": float(kh), "kW": float(kw)}))
        elif kind == "linear":
            ci, co = p["w"].shape
            modules.append(t7.TorchObject("nn.Linear", {
                "weight": rng.uniform(-1, 1, (co, ci)).astype(np.float32) / np.sqrt(ci),
                "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}))
        else:
            c = p["scale"].shape[0]
            modules.append(t7.TorchObject("nn.SpatialBatchNormalization", {
                "weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.uniform(0.0, 0.5, c).astype(np.float32),
                "running_mean": (0.2 * rng.standard_normal(c)).astype(np.float32),
                "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}))
    return modules


def _import_both(blob, tmp_path):
    """The blob through the JAX tool's main and the port's: the two
    mgtpu-ckpt archives, read by the port's reader."""
    import import_t7_model as jax_import

    from mgtpu_torch.tools import import_t7_model
    from mgtpu_torch.utils.bridge import read_mgtpu_ckpt

    flags = ["--netType", NMG["netType"], "--dataset", NMG["dataset"], "--nLayer", "1"]
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    import_t7_model.main([blob, *flags, "--out", ours])
    argv = sys.argv
    sys.argv = ["import_t7_model.py", blob, *flags, "--out", theirs]
    try:
        jax_import.main()
    finally:
        sys.argv = argv
    return read_mgtpu_ckpt(ours), read_mgtpu_ckpt(theirs), theirs


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _assert_same_ckpt(ours, theirs):
    assert ours["meta"] == theirs["meta"] and ours["epoch"] == theirs["epoch"]
    for part in ("params", "stats"):
        a, b = _flat(ours[part]), _flat(theirs[part])
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{part}/{k}"


@pytest.fixture(scope="module")
def blob_modules():
    return _blob_modules(np.random.default_rng(7))


def test_importers_agree_and_the_port_forward_matches_jax(blob_modules, tmp_path):
    """A DataParallelTable of two replicas (replica 1 kept): bit-equal
    trees; the port model loaded from the port's checkpoint forwards
    within 1e-5 of the scale of JAX's model.apply on the JAX import."""
    import jax

    from mgtpu.models import get_net
    from mgtpu.utils.checkpoint import load_checkpoint
    from mgtpu_torch.models import create_model
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.utils.bridge import load_jax_tree

    seq = t7.TorchObject("nn.Sequential", {"modules": blob_modules})
    blob = str(tmp_path / "model_200.t7")
    t7.save(blob, t7.TorchObject("nn.DataParallelTable", {"modules": [seq, seq]}))
    ours, theirs, theirs_path = _import_both(blob, tmp_path)
    _assert_same_ckpt(ours, theirs)
    np.testing.assert_array_equal(ours["params"]["0"]["0"]["conv"]["w"].numpy(),
                                  blob_modules[0]["weight"].transpose(2, 3, 1, 0))

    x = np.random.default_rng(8).standard_normal((2, 32, 32, 3), dtype=np.float32)
    model = load_jax_tree(create_model(NetOpts(**NMG)), ours["params"], ours["stats"]).eval()
    with torch.no_grad():
        y = model(torch.from_numpy(x)).numpy()
    ck = load_checkpoint(theirs_path)
    jm = get_net("cifar/nmg").create_model(types.SimpleNamespace(**NMG, compute_dtype=None))
    ref = np.asarray(jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False)[0])(
        ck["params"], ck["stats"], x))
    assert y.shape == ref.shape == (2, 100) and np.isfinite(y).all()
    scale = np.abs(ref).max()
    assert np.abs(y - ref).max() <= 1e-5 * scale, (np.abs(y - ref).max(), scale)


def test_importers_agree_on_mm_weights_and_running_std(blob_modules, tmp_path):
    """conv 0 as SpatialConvolutionMM (O, I*kH*kW) and BN 0 with the
    legacy running_std: bit-equal trees, the weight unfolded and the
    variance converted."""
    mods = list(blob_modules)
    w4 = np.asarray(mods[0]["weight"])
    mods[0] = t7.TorchObject("nn.SpatialConvolutionMM",
                             {**mods[0].fields, "weight": w4.reshape(w4.shape[0], -1)})
    var = np.asarray(mods[1]["running_var"], np.float64)
    fields = {k: v for k, v in mods[1].fields.items() if k != "running_var"}
    mods[1] = t7.TorchObject("nn.SpatialBatchNormalization",
                             {**fields, "running_std": (1.0 / np.sqrt(var)).astype(np.float32)})
    blob = str(tmp_path / "model_mm.t7")
    t7.save(blob, t7.TorchObject("nn.Sequential", {"modules": mods}))
    ours, theirs, _ = _import_both(blob, tmp_path)
    _assert_same_ckpt(ours, theirs)
    np.testing.assert_array_equal(ours["params"]["0"]["0"]["conv"]["w"].numpy(),
                                  w4.transpose(2, 3, 1, 0))
    np.testing.assert_allclose(ours["stats"]["0"]["0"]["bn"]["var"].numpy(),
                               var.astype(np.float32), rtol=1e-5)


def test_importers_refuse_a_short_blob_alike(blob_modules, tmp_path):
    import import_t7_model as jax_import

    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.tools.import_t7_model import import_model

    blob = str(tmp_path / "model_bad.t7")
    t7.save(blob, t7.TorchObject("nn.Sequential", {"modules": blob_modules[:-1]}))
    with pytest.raises(SystemExit, match="sequences disagree") as ours:
        import_model(blob, NetOpts(**NMG))
    with pytest.raises(SystemExit, match="sequences disagree") as theirs:
        jax_import.import_model(blob, types.SimpleNamespace(**NMG, compute_dtype=None))
    assert str(ours.value) == str(theirs.value)


def test_importers_refuse_a_dropped_bias_alike():
    """A non-zero torch conv bias with no 'b' slot aborts both; an
    all-zero one is allowed by both."""
    import import_t7_model as jax_import

    from mgtpu_torch.tools import import_t7_model

    for fill in (import_t7_model.fill_slot, jax_import.fill_slot):
        mod = t7.TorchObject("nn.SpatialConvolution", {
            "weight": np.zeros((8, 4, 3, 3), np.float32), "bias": np.ones(8, np.float32)})
        with pytest.raises(SystemExit, match="non-zero bias"):
            fill("conv", "conv", mod, {"w": np.zeros((3, 3, 4, 8), np.float32)}, {})
        mod.fields["bias"] = np.zeros(8, np.float32)
        fill("conv", "conv", mod, {"w": np.zeros((3, 3, 4, 8), np.float32)}, {})


def test_import_refuses_an_unfilled_slot(blob_modules, tmp_path):
    """A BN without running_var or running_std leaves its variance slot
    unfilled: the port refuses it, as the JAX tool's abstract leaves do."""
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.tools.import_t7_model import import_model

    mods = list(blob_modules)
    mods[1] = t7.TorchObject("nn.SpatialBatchNormalization",
                             {k: v for k, v in mods[1].fields.items() if k != "running_var"}
                             | {"running_mean": mods[1]["running_mean"]})
    blob = str(tmp_path / "model_novar.t7")
    t7.save(blob, t7.TorchObject("nn.Sequential", {"modules": mods}))
    with pytest.raises(SystemExit, match="1 parameters were not filled"):
        import_model(blob, NetOpts(**NMG))
