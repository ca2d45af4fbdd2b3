"""SGD with momentum and coupled weight decay (counterpart of
`mgtpu/train/optim.py`), in f32, in place:

    g  <- g + wd * p          (L2 added into the gradient)
    m  <- mu * m + g          (dampening 0, no nesterov)
    p  <- p - lr * m

The state is ``{"m": [one buffer per parameter]}``, in the order of the
parameter list it was made for. ``foreach=True`` updates all tensors
with PyTorch's multi-tensor ops; ``foreach=False`` loops over them. The
two give the same values (tests/test_torch_train.py).
"""

from __future__ import annotations

import torch


def sgd_init(params) -> dict:
    return {"m": [torch.zeros_like(p) for p in params]}


@torch.no_grad()
def sgd_update(params, grads, state, lr: float, wd: float, momentum: float = 0.9,
               foreach: bool = True) -> None:
    """Update ``params`` and ``state`` in place; ``grads`` is consumed
    (it receives the weight-decay term)."""
    params, grads, ms = list(params), list(grads), state["m"]
    if foreach:
        torch._foreach_add_(grads, params, alpha=wd)
        torch._foreach_mul_(ms, momentum)
        torch._foreach_add_(ms, grads)
        torch._foreach_add_(params, ms, alpha=-lr)
        return
    for p, g, m in zip(params, grads, ms):
        g.add_(p, alpha=wd)
        m.mul_(momentum).add_(g)
        p.add_(m, alpha=-lr)


def reset_momentum(state) -> dict:
    """Zero momentum, as the reference rebuilds its optimizer state
    every epoch (the JAX CLI's -resetMomentum)."""
    return {"m": [torch.zeros_like(m) for m in state["m"]]}
