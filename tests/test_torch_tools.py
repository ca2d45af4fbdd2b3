"""The port's model tools (`mgtpu_torch/tools/`) on the CPU, against the
JAX package's tools (`tools/*.py`) and forward on the same inputs.

- ``model_info``: R-MG-34 at 224 gives the published 32,899,176 params
  and 5,760,277,760 MACs a image without importing JAX, and the
  ``cifar/nmg`` / ``cifar/rnmg`` nLayer 1-4 sweep (``--all-cifar``) the
  JAX tool's params and MACs under MGTPU_NO_FUSED_EXCHANGE=1 (one JAX
  subprocess for the sweep); its as-run count equals the MACs of the
  conv and product nodes of the exported program's graph;
- ``export_model`` on the CPU (``cifar/nmg`` nLayer 1, batch 2, f32;
  and ``-int8 -calib``): the program's graph holds the ``mgtpu::`` ops
  the eager forward launches, and ``serve_exported``, in a subprocess
  that imports no model code, gives ``Server.predict``'s outputs bit for
  bit, and JAX's ``model.apply`` on the same (folded, quantized) tree
  within 1e-5 of the outputs' scale (int8: or three times the change
  that moving the images by 1e-6 makes to JAX's own forward, the rule
  of tests/test_torch_int8_serve.py; JAX's apply jitted, a compile
  costing a fifth of the eager dispatch); the ops' fake implementations
  give the real outputs' shapes and dtypes;
- ``bench_data`` on synthetic data; ``profile_summary`` on a CPU trace
  written by ``-profile`` and, by category, on a synthetic trace with
  device events; ``bench_sgd``'s forms, its floor by the card's full
  name, and the timing helpers.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mgtpu_torch.tools import bench_sgd, bench_serving, bench_step_breakdown, card, export_model
from mgtpu_torch.tools import model_info, profile_summary
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
# modules a program that serves an exported artifact must not import
MODEL_CODE = ("jax", "mgtpu", "mgtpu_torch.nn", "mgtpu_torch.serve", "mgtpu_torch.trainer",
              "mgtpu_torch.ops.mg", "mgtpu_torch.models")


def _python(code, *args, timeout=600):
    r = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                       timeout=timeout, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_model_info_rmg34_published_counts_without_jax():
    out = _python(
        "import json, runpy, sys, torch\n"
        "torch.set_num_threads(2)  # the suite's workers share the cores\n"
        "sys.argv = ['model_info', '-netType', 'ilsvrc/rnmg', '-depth', '34', '-imageCrop', "
        "'224', '-device', 'cpu']\n"
        "runpy.run_module('mgtpu_torch.tools.model_info', run_name='__main__')\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m in ('jax', 'mgtpu') or m.startswith(('jax.', 'mgtpu.')))))\n")
    row, imported = (json.loads(line) for line in out.strip().splitlines()[-2:])
    assert imported == []
    assert row["params"] == 32_899_176
    assert row["macs_per_image"] == 5_760_277_760 and row["formulation"] == "reference"
    # the 4x4/2 up parts run fewer multiply-adds than the dense 3x3 over the upsample
    assert row["macs_per_image_as_run"] == 4_922_338_560 and row["device"] == "cpu"


def test_model_info_cifar_sweep_matches_the_jax_tool(capsys):
    env = dict(os.environ, MGTPU_NO_FUSED_EXCHANGE="1", JAX_PLATFORMS="cpu")
    jax_tool = subprocess.Popen([sys.executable, os.path.join(TOOLS, "model_info.py"),
                                 "--all-cifar"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env)
    try:
        model_info.main(["--all-cifar", "-device", "cpu"])
        ours = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        out, err = jax_tool.communicate(timeout=600)
    finally:
        jax_tool.kill()
    assert jax_tool.returncode == 0, err[-2000:]
    ref = [json.loads(line) for line in out.strip().splitlines()]
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        assert {k: a[k] for k in b} == b
        assert 0 < a["macs_per_image_as_run"] < a["macs_per_image"]


# --- export_model and serve_exported ---------------------------------------
NMG_FLAGS = ["-netType", "cifar/nmg", "-nLayer", "1", "-batch", "2", "-imageCrop", "32",
             "-dtype", "float32", "-device", "cpu"]
# mgtpu:: ops a cifar/nmg nLayer 1 forward calls: one conv3x3 a 3x3 same or
# down part, one maxpool2 a pool; under int8 one conv_i8 a conv part and
# one quant_i8_group a layer (its 28 parts in 5: the input pyramid's
# three images, then four MgConvs' parts; no conv outside a layer takes
# a single quant_i8)
EXPORT_OPS = {"f32": {"mgtpu.conv3x3.default": 17, "mgtpu.maxpool2.default": 19},
              "int8": {"mgtpu.quant_i8_group.default": 5, "mgtpu.conv_i8.default": 28,
                       "mgtpu.maxpool2.default": 19}}
SERVE_CHILD = r"""
import json, sys
from mgtpu_torch.tools import serve_exported
for art, out in zip(sys.argv[2::2], sys.argv[3::2]):
    serve_exported.main([art, sys.argv[1], "--out", out, "-device", "cpu"])
print(json.dumps(sorted(m for m in sys.modules if m in {model_code} or m.startswith(
    tuple(p + "." for p in {model_code})))))
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """cifar/nmg exported in f32, and int8 with static scales from two
    calibration images, then both served by serve_exported in one
    subprocess: (tmp dir, {mode: (the artifact, its flags, the served
    outputs)}, the subprocess's output)."""
    tmp = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(5)
    np.save(tmp / "calib.npy", rng.standard_normal((2, 32, 32, 3), dtype=np.float32))
    np.save(tmp / "images.npy", rng.standard_normal((2, 32, 32, 3), dtype=np.float32))
    arts = {}
    for mode, extra in (("f32", []), ("int8", ["-int8", "-calib", str(tmp / "calib.npy")])):
        art = tmp / f"nmg_{mode}.pt2"
        argv = NMG_FLAGS + extra + ["-out", str(art)]
        with contextlib.redirect_stdout(io.StringIO()) as said:
            export_model.main(argv)
        assert said.getvalue().startswith("exported cifar/nmg fwd (batch 2, float32")
        arts[mode] = (art, argv)
    child = SERVE_CHILD.replace("{model_code}", repr(MODEL_CODE))
    out = _python(child, str(tmp / "images.npy"),
                  *(str(p) for mode, (art, _) in arts.items()
                    for p in (art, tmp / f"y_{mode}.npy")))
    return tmp, {mode: (art, argv, np.load(tmp / f"y_{mode}.npy"))
                 for mode, (art, argv) in arts.items()}, out


def _ops(program):
    counts = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("mgtpu."):
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


def _graph_macs(program) -> int:
    """Multiply-adds of the conv and product nodes of an exported graph,
    from the shapes the tracer recorded: the as-run count, batch
    included."""
    macs = 0
    for node in program.graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        val = [a.meta.get("val") if isinstance(a, torch.fx.Node) else a for a in node.args]
        out = node.meta.get("val")
        if name == "mgtpu.conv3x3.default":
            macs += out[0].numel() * 9 * val[0].shape[3]
        elif name == "aten.conv2d.default":
            macs += out.numel() * math.prod(val[1].shape[1:])
        elif name == "aten.conv_transpose2d.input":
            macs += val[0].numel() * math.prod(val[1].shape[1:])
        elif name == "aten.matmul.default":
            macs += out.numel() * val[0].shape[-1]
        else:
            assert not any(k in name for k in ("conv", "mm", "linear")), name
    return macs


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_exported_program_serves_server_predict_and_jax(exported, mode):
    import jax
    import jax.numpy as jnp

    from mgtpu.models import get_net
    from mgtpu_torch.utils.bridge import export_jax_tree

    tmp, arts, served = exported
    art, argv, y = arts[mode]
    program = torch.export.load(str(art))
    assert _ops(program) == EXPORT_OPS[mode]
    assert json.loads(served.strip().splitlines()[-1]) == []
    assert served.count("artifact expects (2, 32, 32, 3) torch.float32, on cpu") == 2

    server = export_model.build_server(export_model.parser().parse_args(argv))
    x = np.load(tmp / "images.npy")
    np.testing.assert_array_equal(y, server.predict(x).numpy())

    p, s = export_jax_tree(server.model)
    jm = get_net("cifar/nmg").create_model(types.SimpleNamespace(nLayer=1, nEpochs=200,
                                                                 shortcutType="A"))
    apply = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False)[0])
    ref = np.asarray(apply(p, s, jnp.asarray(x)))
    own = 0.0
    if mode == "int8":
        moved = x * (1 + 1e-6 * np.random.default_rng(6).standard_normal(x.shape)).astype(
            np.float32)
        own = np.abs(np.asarray(apply(p, s, jnp.asarray(moved))) - ref).max()
    err, scale = np.abs(y - ref).max(), np.abs(ref).max()
    assert y.shape == ref.shape == (2, 100) and err <= max(1e-5 * scale, 3 * own), (err, scale)
    if mode == "f32":  # the exported graph's convs are model_info's as-run count
        info = model_info.model_info("cifar/nmg", 32, "cpu", nLayer=1)
        assert _graph_macs(program) == 2 * info["macs_per_image_as_run"]


def test_serve_exported_refuses_another_device(exported):
    from mgtpu_torch.tools import serve_exported

    _, arts, _ = exported
    with pytest.raises(SystemExit, match="exported on cpu, not cuda"):
        serve_exported.load(str(arts["f32"][0]), "cuda")


def test_export_refuses_allow_pickle(tmp_path):
    with pytest.raises(SystemExit, match="never unpickles"):
        export_model.main(NMG_FLAGS + ["-allow-pickle", "-out", str(tmp_path / "x.pt2")])


def test_op_fakes_give_the_real_shapes():
    """Each mgtpu:: op's fake implementation gives its CPU
    implementation's output shapes and dtypes (odd sizes, slices,
    strides and the int8 "up" upsample included)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mgtpu_torch.ops import cuda_conv_i8, library  # noqa: F401 (registers the ops)

    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 7, 9, 16), generator=g)
    w = torch.randn((3, 3, 24, 8), generator=g)[:, :, 4:20]  # an input-channel slice
    b, sc, sh = torch.randn(8, generator=g), torch.rand(16, generator=g), torch.randn(16)
    x8 = torch.randint(-127, 128, (2, 7, 9, 16), dtype=torch.int8, generator=g)
    w8 = torch.randint(-127, 128, (3, 3, 16, 8), dtype=torch.int8, generator=g)
    v, sx = torch.rand(8, generator=g), torch.tensor(0.02)
    y_in = torch.randn((2, 4, 5, 8)).to(torch.bfloat16)
    ops = torch.ops.mgtpu
    calls = [
        (ops.conv3x3, (x, w, b, True, True)),
        (ops.conv3x3_bn_relu_in, (x, w, b, sc, sh, False, False)),
        (ops.maxpool2, (x,)),
        (ops.conv_i8, (x8, w8, 2, 1, v, torch.bfloat16, sx, y_in, b, True, None)),
        (ops.conv_i8, (x8, w8[:1, :1], 1, 0, None, torch.int32, None, None, None, False, None)),
        (ops.quant_i8, (x, None, [13, 17])),
        (ops.quant_i8, (x.to(torch.bfloat16), sx, None)),
    ]
    for op, args in calls:
        real = op(*args)
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = op(*args)
        for r, f in zip(*((t,) if isinstance(t, torch.Tensor) else t for t in (real, fake))):
            assert (tuple(r.shape), r.dtype) == (tuple(f.shape), f.dtype), op
    # conv_i8's op writes a new tensor, the eager call adds into y_in
    y_op = ops.conv_i8(*calls[3][1])
    y_eager = cuda_conv_i8.conv_i8(x8, w8, 2, 1, v, torch.bfloat16, sx=sx, y_in=y_in.clone(),
                                   bias=b, relu=True)
    assert torch.equal(y_op, y_eager) and y_op.data_ptr() != y_in.data_ptr()


# --- the benches and the profile summary ----------------------------------
def test_bench_data_synthetic(capsys):
    from mgtpu_torch.tools import bench_data

    bench_data.main(["-dataset", "cifar100-whitened", "-batchSize", "8", "-iters", "3",
                     "-workers", "2", "-synthSize", "64", "-imageSize", "36",
                     "-imageCrop", "32"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row == {**row, "dataset": "cifar100-whitened", "workers": 2, "mode": "thread",
                   "native": True}
    assert row["images_per_sec"] > 0


def test_profile_summary_reads_a_cpu_profile(tmp_path, capsys):
    """-profile on the CPU writes trace.json (an epoch of 3 iterations:
    the trace closes at its end); the summary finds no device events in
    it and says so."""
    from mgtpu_torch import main as tmain

    tmain.main(["-netType", "mnist-cluttered/unmg", "-dataset", "mnist-seg", "-data",
                "synthetic", "-synthSize", "16", "-batchSize", "2", "-nEpochs", "1",
                "-epochSize", "3", "-nDonkeys", "0", "-train", "-device", "cpu",
                "-profile", str(tmp_path / "prof"), "-cache", str(tmp_path / "run")])
    assert (tmp_path / "prof" / "trace.json").exists()
    capsys.readouterr()
    profile_summary.main([str(tmp_path / "prof"), "--steps", "2"])
    out = capsys.readouterr().out
    assert "trace.json" in out and "no device events" in out


def test_profile_summary_categories_and_idle_share(tmp_path, capsys):
    """Device events only, by category; the idle share of the window."""
    def ev(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}

    trace = {"traceEvents": [
        ev("void conv3x3_sm90_kernel<128, false>(CUtensorMap_st, int)", 0, 10),
        ev("void conv3x3_wmma_kernel<true, true>(__nv_bfloat16 const*)", 10, 5),
        ev("void maxpool2_sm90_kernel<__nv_bfloat16>(unsigned char const*)", 20, 4),
        ev("maxpool2_bwd_group_kernel(group::Table)", 24, 2),
        ev("void conv_i8_sm90_kernel<128>(CUtensorMap_st)", 30, 6),
        ev("void quant_kernel<float>(float const*)", 36, 1),
        ev("void absmax_kernel<float>(float const*)", 37, 1),
        ev("sm90_xmma_fprop_implicit_gemm_bf16", 40, 8),
        ev("void at::native::vectorized_elementwise_kernel<4>(int)", 48, 2),
        ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 60, 10),
        ev("Memcpy HtoD (Pageable -> Device)", 70, 5, cat="gpu_memcpy"),
        ev("some_library_kernel", 75, 5),
        ev("aten::conv2d", 0, 100, cat="cpu_op"),  # a host op: not summed
    ]}
    s = profile_summary.summarize(trace)
    assert dict(s["by_category"]) == {
        "conv3x3": 10, "conv3x3_bn_relu_in": 5, "maxpool2": 4, "maxpool2_bwd": 2,
        "conv_i8": 6, "quant_i8": 2, "cuDNN convs": 8, "BN/elementwise": 2, "collectives": 10,
        "copies": 5, "other": 5}
    assert (s["total"], s["busy"], s["window"], s["events"]) == (59, 59, 80, 12)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    profile_summary.main([str(tmp_path), "--steps", "2"])
    out = capsys.readouterr().out
    assert f"idle {21 / 80:.1%}" in out and "conv3x3_bn_relu_in" in out


def test_bench_sgd_forms_agree():
    """The three forms update from one state to the same parameters, bit
    for bit (the same f32 operations on each element)."""
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(shape, generator=g) for shape in ((3, 3, 4, 8), (8,), (16, 10))]
    errors = bench_sgd.one_step_error(params)
    assert errors == {"foreach": 0.0, "flat": 0.0}
    for _, update in bench_sgd.forms(params).values():
        assert bench_sgd.time_update(update, torch.device("cpu"), iters=2, warmup=1) > 0


@pytest.mark.parametrize("device, rate", [("NVIDIA H100 80GB HBM3", 3.35),
                                          ("NVIDIA H100 PCIe", 2.0), ("NVIDIA H100 NVL", 3.9),
                                          ("NVIDIA H100", None), ("cpu", None)])
def test_bench_sgd_floor_names_the_part(device, rate):
    """The floor is read by the card's full name: each H100 part has its
    own memory rate, and a name not listed has no floor."""
    text = bench_sgd.floor_text(20 * 10**9, device)
    if rate is None:
        assert text.startswith("not known for this device") and device in text
    else:
        assert text == f"{20 / rate:.3f} ms at {rate:.2f} TB/s"


def test_timing_helpers_name_the_device():
    cpu = torch.device("cpu")
    assert card(cpu) == {"device": "cpu", "power_limit": None}
    p50, thr = bench_serving.measure(lambda x: x * 2, torch.zeros(4, 1), cpu)
    assert p50 > 0 and thr > 0
    assert bench_step_breakdown.timeit(lambda: None, cpu, iters=2, warmup=1) >= 0
