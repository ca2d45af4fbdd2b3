"""Dataset registry (a copy of `mgtpu/data/registry.py`) — names mirror the reference's `-dataset` values
(`opts.lua:47`, `data.lua`)."""

from __future__ import annotations


def list_datasets():
    return [
        "cifar10",
        "cifar100",
        "cifar100+",
        "cifar100-whitened",
        "ilsvrc",
        "mnist-seg",
        "mnist-spt",
        "mnist-rot",
        "mnist-sca",
        "mnist-tra",
        "mnist-aff",
        "mnist-rec",
        "mnist-saliency",
    ]


def get_loaders(opt):
    """Returns {"train": loader?, "test": loader?} for opt.dataset."""
    name = opt.dataset
    if name == "cifar100-whitened":
        from mgtpu_torch.data.cifar import build_cifar100_whitened

        return build_cifar100_whitened(opt)
    if name in ("cifar10", "cifar100", "cifar100+"):
        from mgtpu_torch.data.cifar import build_cifar_normalized

        return build_cifar_normalized(opt, name)
    if name == "ilsvrc":
        from mgtpu_torch.data.ilsvrc import build_ilsvrc

        return build_ilsvrc(opt)
    if name == "mnist-saliency":
        from mgtpu_torch.data.mnist import build_mnist_saliency

        return build_mnist_saliency(opt)
    if name.startswith("mnist-"):
        from mgtpu_torch.data.mnist import build_mnist_task

        return build_mnist_task(opt, name)
    raise KeyError(f"unknown dataset '{name}'; available: {list_datasets()}")
