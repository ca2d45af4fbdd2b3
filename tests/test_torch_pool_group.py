"""The grouped pool backward (`mgtpu_torch.ops.cuda_pool.maxpool2_group`,
`maxpool2_backward_group`) on the CPU.

A multigrid layer's pools form one group, whose backward is one launch of
the group design (`mgtpu_torch/csrc/maxpool2.cu`, section "group") on the
card. Here: the group's gradients equal the single pool's bit for bit and
JAX's (`jax.vjp` of `mgtpu.ops.resample.maxpool2_ceil` under the first-tie
rule, of the Pallas kernel `maxpool2_pallas` in interpret mode under the
all-ties rule), exactly; a numpy walk of the kernel's index plan (the
member table `_group_table` fills, the tiles' prefix sums, block ->
member, item -> (n, oh, ow, lane)) gives the plain backward; and the
grouped launches a training micro-batch makes are pinned for every net.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import (CIFAR_PER_MICRO, CIFAR_RECIPES, PER_STEP, RMG34, SEG_PER_MICRO,
                        SEG_RECIPES, cifar_opts, record_kernel_shapes)
from mgtpu.ops.pallas_pool import maxpool2_pallas
from mgtpu.ops.resample import maxpool2_ceil as jax_maxpool2_ceil
from mgtpu_torch.ops import cuda_pool
from mgtpu_torch.ops.cuda_pool import (GROUP_THREADS, MAX_MEMBERS, _group_plan, _group_table,
                                       maxpool2, maxpool2_bwd_plain, maxpool2_group,
                                       maxpool2_plain)

H100_SMS = 132


def _x(shape, seed, ties=False, specials=False):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    if ties:  # ReLU outputs on a coarse grid: ties at zero and at positive values
        x = np.maximum(np.round(x * 2) / 2, 0)
    if specials:
        x[0, 0, 0, 0] = np.nan
        x[0, -1, -1, -1] = np.inf
        x[-1, :2, :2, :] = -np.inf  # a window of -inf only
        x[-1, -1, -1, -1] = np.nan  # in a clipped edge window when H or W is odd
    return x


# a layer's pyramid (finest first) and odd-sized, narrow members
PYRAMID = [(2, 16, 12, 8), (2, 8, 6, 16), (2, 4, 3, 32)]
ODD = [(2, 7, 9, 3), (1, 5, 4, 6), (3, 3, 3, 8)]


def _grads(fn, xs, gs, used):
    """d(sum of used outputs * g)/dx of each input; None where unused"""
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    ys = fn(ts)
    loss = sum((y * torch.from_numpy(g)).sum() for y, g, u in zip(ys, gs, used) if u)
    loss.backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("shapes", [PYRAMID, ODD])
@pytest.mark.parametrize("ties", ["all", "first"])
@pytest.mark.parametrize("used", [(True, True, True), (True, False, True), (False, False, True)])
def test_group_grads_equal_single_pools(shapes, ties, used):
    """The group's gradients are the single pools' bit for bit, with some
    outputs given no cotangent (their inputs get none)."""
    xs = [_x(s, seed=k, ties=True, specials=k == 1) for k, s in enumerate(shapes)]
    gs = [_x(maxpool2_plain(torch.from_numpy(x)).shape, seed=10 + k) for k, x in enumerate(xs)]
    got = _grads(lambda ts: maxpool2_group(ts, ties), xs, gs, used)
    ref = _grads(lambda ts: [maxpool2(t, ties) for t in ts], xs, gs, used)
    for a, b, u in zip(got, ref, used):
        assert (a is None) == (not u) and (b is None) == (not u)
        if u:
            assert torch.equal(a, b)


def test_group_forward_is_the_single_pools():
    xs = [torch.from_numpy(_x(s, seed=k, specials=True)) for k, s in enumerate(ODD)]
    for y, x in zip(maxpool2_group(xs, "first"), xs):
        torch.testing.assert_close(y, maxpool2_plain(x), rtol=0, atol=0, equal_nan=True)
    assert maxpool2_group((), "first") == ()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_grads_match_jax_first_tie_rule(dtype):
    """ties="first" against jax.vjp of maxpool2_ceil (XLA's
    SelectAndScatter), odd sizes included, exactly."""
    shapes = PYRAMID + ODD
    np_t = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    xs = [_x(s, seed=20 + k, ties=True).astype(np_t) for k, s in enumerate(shapes)]
    gs = [_x(jax_maxpool2_ceil(jnp.asarray(x)).shape, seed=30 + k).astype(np_t)
          for k, x in enumerate(xs)]
    ts = [torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype)).requires_grad_()
          for x in xs]
    ys = maxpool2_group(ts, "first")
    sum((y.float() * torch.from_numpy(g.astype(np.float32))).sum() for y, g in zip(ys, gs)
        ).backward()
    for t, x, g in zip(ts, xs, gs):
        ref = jax.vjp(jax_maxpool2_ceil, jnp.asarray(x))[1](jnp.asarray(g))[0]
        np.testing.assert_array_equal(t.grad.float().numpy(), np.asarray(ref).astype(np.float32))


def test_group_grads_match_pallas_all_ties_rule():
    """ties="all" against jax.vjp of the Pallas kernel in interpret mode
    (even sizes, the kernel's), exactly."""
    shapes = [(2, 8, 16, 5), (2, 4, 8, 3), (1, 2, 4, 7)]
    xs = [_x(s, seed=40 + k, ties=True) for k, s in enumerate(shapes)]
    gs = [_x(maxpool2_plain(torch.from_numpy(x)).shape, seed=50 + k) for k, x in enumerate(xs)]
    got = _grads(lambda ts: maxpool2_group(ts, "all"), xs, gs, (True,) * 3)
    with pltpu.force_tpu_interpret_mode():
        for a, x, g in zip(got, xs, gs):
            ref = jax.vjp(maxpool2_pallas, jnp.asarray(x))[1](jnp.asarray(g))[0]
            np.testing.assert_array_equal(a.numpy(), np.asarray(ref))


# ------------------------------------------------- the kernel's index plan

def _walk(members, ties, sms):
    """The group kernel's walk in numpy, from the member table and grid
    that _group_table gives for ``members`` [(x, y, g, dx)]: blocks take
    tiles b, b + grid, ...; a tile's member is the last whose tile0 it
    has reached (the kernel's scan); a tile's items are base + k*THREADS
    for each thread, k < per_thread, below the member's items; an item is
    (n, oh, ow, lane) with the lane fastest; each of up to four window
    corners in row-major order gets g where x equals y (the first one
    only under "first"). Returns each member's dx and checks that every
    element of it is written exactly once."""
    table, grid = _group_table(members, sms)
    m = table.m
    assert 1 <= table.count <= MAX_MEMBERS and table.count == len(members)
    assert [m[j].tile0 for j in range(table.count)] == [
        sum(-(-m[i].items // (table.per_thread * GROUP_THREADS)) for i in range(j))
        for j in range(table.count)]
    out = [np.zeros(x.numel()) for x, *_ in members]
    written = [np.zeros(x.numel(), dtype=int) for x, *_ in members]
    seen = np.zeros(table.tiles, dtype=int)
    for block in range(grid):
        for tl in range(block, table.tiles, grid):
            seen[tl] += 1
            j = max(k for k in range(table.count) if tl >= m[k].tile0)
            t = m[j]
            x, y, g, _ = (a.float().numpy().ravel() for a in members[j])
            v = t.c // t.lanes
            assert v == (16 // members[j][0].element_size() if t.vec else 1)
            base = (tl - t.tile0) * table.per_thread * GROUP_THREADS + np.arange(GROUP_THREADS)
            item = np.concatenate([base + k * GROUP_THREADS for k in range(table.per_thread)])
            item = item[item < t.items]
            lane, rest = item % t.lanes, item // t.lanes
            ow, rest = rest % t.ow, rest // t.ow
            oh, n = rest % t.oh, rest // t.oh
            x0 = ((n * t.h + 2 * oh) * t.w + 2 * ow) * t.lanes + lane
            for e in range(v):
                yv, gv = y[item * v + e], g[item * v + e]
                taken = np.zeros(len(item), dtype=bool)
                for a in (0, 1):
                    for b in (0, 1):
                        inside = (2 * oh + a < t.h) & (2 * ow + b < t.w)
                        off = (x0 + a * t.w * t.lanes + b * t.lanes) * v + e
                        off = np.where(inside, off, 0)
                        hit = inside & (x[off] == yv)
                        if ties == "first":
                            hit &= ~taken
                            taken |= hit
                        np.add.at(written[j], off[inside], 1)
                        out[j][off[inside]] = np.where(hit, gv, 0.0)[inside]
    assert (seen == 1).all()
    assert all((w == 1).all() for w in written)
    return [o.reshape(x.shape) for o, (x, *_) in zip(out, members)]


def _members(shapes, dtype, seed, offset=0):
    """(x, y, g, dx) of each shape; with ``offset`` the first x starts that
    many elements past its buffer (its lanes one element wide)"""
    out = []
    for k, shape in enumerate(shapes):
        x = torch.from_numpy(_x(shape, seed=seed + k, ties=True, specials=True)).to(dtype)
        if k == 0 and offset:
            buf = torch.empty(x.numel() + offset, dtype=dtype)
            buf[offset:] = x.ravel()
            x = buf[offset:].view(shape)
        y = maxpool2_plain(x)
        g = torch.from_numpy(_x(tuple(y.shape), seed=seed + 50 + k)).to(dtype)
        out.append((x, y, g, torch.empty_like(x)))
    return out


WALKS = {
    "pyramid": PYRAMID,  # 16-byte lanes
    "odd": ODD,  # C of 3 and 6: one-element lanes
    "mixed": [(2, 9, 7, 16), (1, 3, 5, 5), (2, 6, 6, 24)],
    "many": [(1, 3 + j, 2 + j, 8 * (1 + j % 3)) for j in range(MAX_MEMBERS)],
    "large": [(4, 46, 30, 64), (4, 23, 15, 32)],  # several items a thread
}


@pytest.mark.parametrize("case", sorted(WALKS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ties", ["all", "first"])
@pytest.mark.parametrize("sms", [H100_SMS, 3])
def test_walk_of_the_index_plan_gives_the_plain_backward(case, dtype, ties, sms):
    members = _members(WALKS[case], dtype, seed=60, offset=1 if case == "mixed" else 0)
    for dx, (x, y, g, _) in zip(_walk(members, ties, sms), members):
        ref = maxpool2_bwd_plain(x, y, g, ties).float().numpy()
        np.testing.assert_array_equal(dx, ref)


def test_the_plan_fills_the_card_and_splits_at_max_members():
    # R-MG-34's largest pool at batch 128: two 16-byte lanes a thread, one
    # resident wave of 2 blocks an SM
    assert _group_plan(((128, 56, 56, 64, 8),), H100_SMS) == (2, 264, 1568, ((802816, 0),))
    # cifar/prnmg's smallest group at micro-batch 64: one lane a thread
    # for the most blocks
    per_thread, grid, tiles, plan = _group_plan(
        ((64, 8, 8, 128, 8), (64, 4, 4, 256, 8), (64, 2, 2, 512, 8)), H100_SMS)
    assert (per_thread, grid, tiles) == (1, 112, 112)
    assert plan == ((16384, 0), (8192, 64), (4096, 96))
    with pytest.raises(ValueError, match="members"):
        _group_plan(((1, 2, 2, 8, 8),) * (MAX_MEMBERS + 1), H100_SMS)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so the wrapper plans
    launches for it"""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_more_than_max_members_take_two_launches(monkeypatch):
    """A group of MAX_MEMBERS + 1 is launched as MAX_MEMBERS and 1 (a
    member without a cotangent in neither), each launch's table walked to
    the plain backward."""
    members = _members([(1, 4 + j, 3 + j, 8) for j in range(MAX_MEMBERS + 2)],
                       torch.float32, seed=70)
    launches = []
    monkeypatch.setattr(cuda_pool, "_checked", lambda x, y, g, ties: (x, y, g))
    monkeypatch.setattr(cuda_pool, "_launch_group",
                        lambda ms, ties: launches.append(_walk(ms, ties, H100_SMS)))
    xs, ys, gs, _ = zip(*members)
    gs = list(gs[:4]) + [None] + list(gs[5:])
    dxs = cuda_pool.maxpool2_backward_group([x.as_subclass(_OnCard) for x in xs], ys, gs, "first")
    assert [len(walked) for walked in launches] == [MAX_MEMBERS, 1]
    assert dxs[4] is None
    walked = [dx for out in launches for dx in out]
    for got, x, y, g in zip(walked, xs[:4] + xs[5:], ys[:4] + ys[5:], gs[:4] + gs[5:]):
        np.testing.assert_array_equal(got, maxpool2_bwd_plain(x, y, g, "first").numpy())


# ------------------------------------------------ the launches of each net

NETS = {"ilsvrc/rnmg": (RMG34, PER_STEP, 46),
        **{net: (cifar_opts(net), CIFAR_PER_MICRO[net], pools) for net, pools in zip(
            CIFAR_RECIPES, (28, 66, 42, 32, 5, 5))},
        **{net: (SEG_RECIPES[net][0], SEG_PER_MICRO[net], pools) for net, pools in zip(
            SEG_RECIPES, (3, 13, 15, 33, 57))}}


@pytest.mark.parametrize("net", sorted(NETS))
def test_grouped_launches_per_micro_batch_are_pinned(net):
    """A training micro-batch's pool backward: the pinned launches (one
    per multigrid layer's group of pools), and in them every pool the
    step differentiates, at most MAX_MEMBERS a launch."""
    opt, pins, pools = NETS[net]
    groups = record_kernel_shapes(True, opt)["maxpool2_bwd"]
    assert sum(groups.values()) == pins["maxpool2_bwd"]
    assert sum(len(key) * n for key, n in groups.items()) == pools
    assert all(1 <= len(key) <= MAX_MEMBERS for key in groups)
