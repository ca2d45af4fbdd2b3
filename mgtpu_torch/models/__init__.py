"""Model registry of the port: ``-netType`` name -> NetSpec (the model,
its input and target shapes, loss, LR rule and metrics): R-MG-18/34 and
PR-MG-30/52 (``ilsvrc/``), the CIFAR zoo (``cifar/``) and the
cluttered-MNIST nets and the ``mnist-test`` and ``mnist-saliency``
harnesses (``mnist-cluttered/``): the JAX package's whole zoo."""

from __future__ import annotations

from mgtpu_torch.models.base import NetOpts, NetSpec
from mgtpu_torch.models.cifar import nmg, pnmg, prnmg, resnet, rnmg, vgg
from mgtpu_torch.models.ilsvrc import prnmgseg
from mgtpu_torch.models.ilsvrc import rnmg as ilsvrc_rnmg
from mgtpu_torch.models.mnist_cluttered import (mnist_saliency, mnist_test, pnmg_mnist,
                                                prnmg_mnist, unet, unmg)
from mgtpu_torch.ops.mg import number_layers

_SPECS = {spec.name: spec for spec in (ilsvrc_rnmg.NET, prnmgseg.NET, nmg.NET, rnmg.NET,
                                       pnmg.NET, prnmg.NET, resnet.NET, vgg.NET, unet.NET,
                                       unmg.NET, pnmg_mnist.NET, prnmg_mnist.NET,
                                       mnist_test.NET, mnist_saliency.NET)}


def list_models() -> list[str]:
    return sorted(_SPECS)


def get_spec(name: str) -> NetSpec:
    """The NetSpec registered under ``name`` (the JAX package's
    ``-netType``)."""
    if name not in _SPECS:
        raise KeyError(f"unknown net {name!r}; the nets: {list_models()}")
    return _SPECS[name]


def net_options(opt: NetOpts) -> NetOpts:
    """``opt`` with what it leaves to its net filled in (the depth)."""
    return get_spec(opt.netType).options(opt)


def create_model(opt: NetOpts = NetOpts(), compute_dtype=None, device=None, generator=None):
    """The net ``opt`` names (default R-MG-34), its init drawn from
    ``generator`` (a CPU ``torch.Generator``), in eval mode (a trainer
    calls ``.train()``), its multigrid layers numbered for their spans
    (`mgtpu_torch.ops.mg.number_layers`)."""
    model = get_spec(opt.netType).create_model(net_options(opt), compute_dtype=compute_dtype,
                                               device=device, generator=generator)
    number_layers(model)
    return model
