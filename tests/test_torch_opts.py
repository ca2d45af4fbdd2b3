"""The port's option parser (`mgtpu_torch/utils/opts.py`) against the JAX
package's (`mgtpu/utils/opts.py`): every recipe under scripts/ parses to
the same values, key by key, and to the same run-dir flag string (the
saliency recipe with the harness's flags too); what the port does not
have yet is refused with the ROADMAP item that ports it; the int8 flags
follow the JAX Session's rules. Exact comparisons
(parsed values, no arithmetic)."""

import os

import pytest

from mgtpu.utils import opts as jax_opts
from mgtpu_torch.utils import opts
from test_scripts import SCRIPTS, recipe_argv

SALIENCY = [p for p in SCRIPTS if "mnist-saliency" in p]
RUNNABLE = [p for p in SCRIPTS if p not in SALIENCY]


def _flag_string(opt):
    """The run dir without its time stamp: cache/dataset/net/flags."""
    return os.path.dirname(opt.save)


@pytest.mark.parametrize("path", RUNNABLE, ids=[os.path.basename(p) for p in RUNNABLE])
@pytest.mark.parametrize("extra", [[], ["-dtype", "bfloat16", "-nEpochs", "2", "-tenCrop",
                                        "-retrain", "model_1.ckpt", "-epochNumber", "2"]],
                         ids=["recipe", "recipe+flags"])
def test_recipe_parses_to_the_jax_values(path, extra):
    argv = recipe_argv(path) + extra
    ref, got = jax_opts.parse(argv), opts.parse(argv)
    want = {k: v for k, v in vars(ref).items() if k not in ("compute_dtype", "save")}
    have = {k: v for k, v in vars(got).items() if k not in ("device", "save")}
    assert have == want
    assert got.device == "cuda"
    assert _flag_string(got) == _flag_string(ref)
    # -device is left out of the run dir
    assert _flag_string(opts.parse(argv + ["-device", "cpu"])) == _flag_string(ref)


@pytest.mark.parametrize("path", SALIENCY, ids=[os.path.basename(p) for p in SALIENCY])
def test_saliency_recipe_is_refused(path):
    """Refused until the saliency harness was ported: the recipe, with
    the harness's -trainedNet and the device probe, now parses to the
    JAX values and run dir."""
    argv = recipe_argv(path) + ["-trainedNet", "model_1.ckpt", "-saliencyDumpStack", "0"]
    ref, got = jax_opts.parse(argv), opts.parse(argv)
    want = {k: v for k, v in vars(ref).items() if k not in ("compute_dtype", "save")}
    assert {k: v for k, v in vars(got).items() if k not in ("device", "save")} == want
    assert (got.pipeline, got.trainedNet, got.saliencyDumpStack) == ("saliency", "model_1.ckpt",
                                                                    0)
    assert _flag_string(got) == _flag_string(ref)


BASE = ["-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-train"]


@pytest.mark.parametrize("flags,item", [
    (["-allowPickleCkpt"], "never unpickles"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_unported_flag_is_refused(flags, item):
    with pytest.raises(SystemExit, match=item):
        opts.parse(BASE + flags)
    jax_opts.parse(BASE + flags)  # the JAX CLI takes it


@pytest.mark.parametrize("flags", [["-remat"], ["-pipeline", "saliency"],
                                   ["-saliencyBatch", "8"], ["-saliencyDumpStack", "0"],
                                   ["-zero1"], ["-multihost"], ["-spatial", "2"],
                                   ["-tensor", "2"]],
                         ids=lambda v: v[0])
def test_ported_flag_parses_to_the_jax_values(flags):
    """The train step's -remat, the saliency harness's flags, the data
    parallelism's -zero1 and -multihost and the mesh's second axis
    (-spatial, -tensor), refused until they were ported, parse to the
    JAX values and run dir."""
    ref, got = jax_opts.parse(BASE + flags), opts.parse(BASE + flags)
    name = flags[0][1:]
    assert getattr(got, name) == getattr(ref, name) != jax_opts.build_parser().get_default(name)
    assert _flag_string(got) == _flag_string(ref)


TEST = ["-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-test"]


@pytest.mark.parametrize("flags", [["-int8"], ["-int8", "-int8Calib", "8"], ["-int8Calib", "8"]],
                         ids=["-int8", "-int8Calib", "-int8Calib-alone"])
def test_int8_flags_parse_to_the_jax_values(flags):
    """-int8 and -int8Calib parse to the JAX values and run dir; without
    -int8, -int8Calib is parsed and ignored, as the JAX Session ignores
    it (the Session quantizes only under -int8)."""
    ref, got = jax_opts.parse(TEST + flags), opts.parse(TEST + flags)
    assert (got.int8, got.int8Calib) == (ref.int8, ref.int8Calib)
    assert _flag_string(got) == _flag_string(ref)


def test_int8_with_train_is_refused_in_the_jax_words():
    """The JAX Session stops -train -int8 ("-int8 is an inference-only
    path; drop -train"); the port stops it at parsing, in those words."""
    with pytest.raises(SystemExit, match="-int8 is an inference-only path; drop -train"):
        opts.parse(BASE + ["-int8"])
    jax_opts.parse(BASE + ["-int8"])  # the JAX parser takes it; its Session refuses


def test_net_flags_take_a_single_dash():
    opt = opts.parse(["-netType", "ilsvrc/prnmgseg", "-depth", "52", "-shortcutType", "C",
                      "-test"])
    assert (opt.depth, opt.shortcutType) == (52, "C")
    assert opts.parse(["-netType", "cifar/pnmg", "-nLayer", "2", "-isDropout",
                       "-test"]).isDropout
    with pytest.raises(SystemExit):  # the JAX CLI's error: no running scheme
        opts.parse(["-netType", "cifar/nmg"])
