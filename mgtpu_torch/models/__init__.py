"""Model registry of the port: name -> model constructor, and name ->
NetSpec (loss, LR rule and metrics)."""

from __future__ import annotations

from mgtpu_torch.models.ilsvrc import rnmg

_NETS = {"ilsvrc/rnmg": rnmg.build_ilsvrc_rnmg}
_SPECS = {"ilsvrc/rnmg": rnmg.NET}


def get_net(name: str):
    """The builder registered under ``name`` (the JAX package's
    ``-netType``); only ``ilsvrc/rnmg`` is ported so far."""
    if name not in _NETS:
        raise KeyError(f"unknown or not yet ported net {name!r}; ported: {sorted(_NETS)}")
    return _NETS[name]


def get_spec(name: str):
    """The NetSpec registered under ``name``."""
    get_net(name)  # the same error for an unknown name
    return _SPECS[name]
