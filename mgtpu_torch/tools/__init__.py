"""The tools of the port, each run as ``python -m
mgtpu_torch.tools.<name>``: the counterparts of the JAX package's
``tools/*.py``. Those that load model code (``read_t7``,
``import_t7_model``, ``model_info``, ``export_model``, ``serve_exported``,
``bench_serving``, ``bench_step_breakdown``, ``bench_sgd``,
``profile_summary``, ``bench_data``) run on the card unless given
``-device cpu``. The data and file tools (``download_mnist``,
``generate_mnist_cluttered``, ``ingest_cifar``, ``seg_metrics``,
``render_predictions``, ``render_saliency``) use no device and import no
torch; ``soak_chain`` chains ``python -m mgtpu_torch.main`` processes.
This package imports no torch until a function here is called."""

from __future__ import annotations

import subprocess


def sync(device) -> None:
    """Wait for the work queued on ``device`` (a torch.device)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def card(device) -> dict:
    """The device a timed line was taken on: a card's name and power
    limit (``nvidia-smi``; None where it cannot be read), or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        limit = smi.stdout.strip() if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit or None}
