"""The model tools of the port, each run as ``python -m
mgtpu_torch.tools.<name>``: the counterparts of the JAX package's
``tools/*.py`` that load model code (``read_t7``, ``import_t7_model``,
``model_info``, ``export_model``, ``serve_exported``, ``bench_serving``,
``bench_step_breakdown``, ``bench_sgd``, ``profile_summary``,
``bench_data``). Each runs on the card unless given ``-device cpu``."""

from __future__ import annotations

import subprocess

import torch


def sync(device: torch.device) -> None:
    """Wait for the work queued on ``device``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device: torch.device) -> dict:
    """The device a timed line was taken on: a card's name and power
    limit (``nvidia-smi``; None where it cannot be read), or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        limit = smi.stdout.strip() if smi.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return {"device": torch.cuda.get_device_name(index), "power_limit": limit or None}
