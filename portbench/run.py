"""The port's benchmark: one cell, one run, one process, on one card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is `cells/<cell>.json`: its configuration (`configs/<config>.json`,
the net and its options), its traffic (`traffic/<traffic>.json`, whose
``driver`` names `drivers/<driver>.py` and whose other keys are that
driver's parameters), and the limits of the numbers its driver compares
with the reference. A configuration of a net that `reference/mgnet.py`
lacks names the `reference/<module>.py` that adds it (``"reference"``).
The driver builds the program (`mgtpu_torch`) from
the benchmark's weights, warms up the cell's shapes, measures for
``--seconds`` and checks what the window produced against the reference.
With ``--trace 1`` a short slice is profiled after the window, and every
`metrics/<metric>.py` reads its number from it (a reader that finds
nothing to read returns None and its metric is left out); the kernels
each roofline divides by are named in `kernel_classes/<class>.json`.

The last line of standard output is the result; the context (the card,
its power limit and clocks beside the window, the host's CPU, the samples
behind each tail) comes on the lines before it, and each compared number
with its limit closes standard error. A run without a card, or with JAX
or the JAX package loaded once the window has closed, prints no result
and exits non-zero.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mgtpu")  # top-level module names, compared whole
CACHE = HERE.parent / ".portbench_cache"


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(name: str, root: Path = HERE) -> dict:
    """Configuration ``name``; the nets and layer kinds of the reference
    module it names (``"reference"``: `reference/<module>.py` under
    ``root``) registered with `reference.mgnet`."""
    config = load_json("configs", name, root)
    if "reference" in config:
        from portbench.reference import mgnet

        mod = load_module(root / "reference" / f"{config['reference']}.py")
        mgnet.register(mod.NETS, mod.KINDS)
    return config


def cell_files(workload: str, root: Path = HERE):
    """(cell, config, traffic) of ``workload``."""
    cell = load_json("cells", workload, root)
    return (cell, load_config(cell["config"], root), load_json("traffic", cell["traffic"], root))


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Reading:
    """What a per-layer metric reads: the driver's kind, the cell's files,
    the window's rate and dispatch spans, the profiled slice's summary,
    and the work of the configuration's passes from the reference's own
    layer list."""

    def __init__(self, config, traffic, res, profile, root: Path = HERE):
        self.config, self.traffic, self.root = config, traffic, root
        self.driver = traffic["driver"]
        self.rate, self.dispatch, self.work = res["rate"], res["dispatch"], res["work"]
        self.profile = profile
        self._convs = {}

    def convs(self, mode="eval"):
        if mode not in self._convs:
            from portbench.reference import mgnet

            self._convs[mode] = mgnet.conv_shapes(mgnet.build(self.config),
                                                  tuple(self.config["image_shape"]), mode)
        return self._convs[mode]

    def macs_per_image(self):
        from portbench.reference import mgnet

        return mgnet.macs_per_image(mgnet.build(self.config), tuple(self.config["image_shape"]))

    def kernel_patterns(self, cls: str) -> list:
        return load_json("kernel_classes", cls, self.root)["patterns"]

    def class_seconds(self, cls: str) -> float:
        from portbench.common.trace import class_seconds

        return class_seconds(self.profile["by_name"], self.kernel_patterns(cls))


def per_layer(reading) -> dict:
    out = {}
    for path in sorted((reading.root / "metrics").glob("*.py")):
        mod = load_module(path)
        value = mod.read(reading)
        if value is not None:
            out[path.stem] = {"value": value, "unit": mod.UNIT}
    return out


def execute(workload, seed, seconds, tracing, readings=False, device="cuda", root=HERE,
            marks=None):
    """One run of ``workload`` in this process: (harness, driver result);
    ``marks``: set-up's stages before it."""
    import torch

    from portbench.common.harness import Harness

    cell, config, traffic = cell_files(workload, root)
    h = Harness(workload, config, traffic, seed, seconds, tracing, T0, device, readings, marks)
    h.limits = cell.get("limits", {})
    if h.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = load_module(root / "drivers" / f"{traffic['driver']}.py")
    return h, driver.run(h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_json("cells", args.workload)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    import torch

    marks = {"torch": time.perf_counter() - T0}

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from portbench.common.harness import Harness, card_context

    Harness.info(context="before", **card_context())
    h, res = execute(args.workload, args.seed, args.seconds, bool(args.trace), marks=marks)
    Harness.info(context="after", **card_context())
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 4

    if args.trace:
        metrics = per_layer(Reading(h.config, h.traffic, res, h.profile))
    else:
        metrics = {name: {"value": v, "unit": u} for name, (v, u) in res["metrics"].items()}
        metrics["setup_s"] = {"value": h.setup_s, "unit": "s"}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(res["peak"])}
    line = {"correct": h.correct(), "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if h.profile is not None:
        device["busy_s"], device["window_s"] = h.profile["busy_s"], h.profile["window_s"]
        line["breakdown"] = {k: h.profile[k] for k in ("device_ops", "idle_gaps")}
        Harness.info(slice_units=h.profile["units"])
    Harness.info(setup_s=h.setup_s, check_s=h.check_s, setup_marks=h.marks,
                 spans={k: [len(v), sum(v)] for k, v in h.spans.items()})
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in h.checks}
    for n, v, lim in h.checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
