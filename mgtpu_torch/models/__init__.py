"""Model registry of the port: name -> builder."""

from __future__ import annotations

from mgtpu_torch.models.ilsvrc.rnmg import build_ilsvrc_rnmg

_NETS = {"ilsvrc/rnmg": build_ilsvrc_rnmg}


def get_net(name: str):
    """The builder registered under ``name`` (the JAX package's
    ``-netType``); only ``ilsvrc/rnmg`` is ported so far."""
    if name not in _NETS:
        raise KeyError(f"unknown or not yet ported net {name!r}; ported: {sorted(_NETS)}")
    return _NETS[name]
