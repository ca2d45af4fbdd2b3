"""The data layer of the port: the JAX package's loaders, transforms and
donkey pool (`mgtpu/data/`), copied, over the port's native library.
It imports neither torch nor jax, so process-mode donkeys never
initialise CUDA."""

from mgtpu_torch.data.registry import get_loaders, list_datasets
