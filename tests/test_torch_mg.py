"""The port's multigrid blocks (`mgtpu_torch.ops.mg`) against
`mgtpu.ops.mg`, in f32 on the CPU, in eval and train mode: the same
numpy weights (BN affines and running stats drawn away from their init)
go into both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.ops import mg as jmg
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.ops.cuda_pool import maxpool2
from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum, load_jax_tree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter_bn(p, s, rng):
    """Non-trivial BN affines and running stats everywhere in a tree
    (numpy, in place)."""
    for k, v in p.items():
        if k == "bn" and v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = rng.normal(0, 0.5, v["bias"].shape).astype(np.float32)
            s[k]["mean"] = rng.normal(0, 0.5, s[k]["mean"].shape).astype(np.float32)
            s[k]["var"] = rng.uniform(0.25, 2.0, s[k]["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _jitter_bn(v, s.get(k, {}), rng)
    return p, s


def _weights(jblock, seed):
    p, s = _np(jblock.init(jax.random.PRNGKey(seed)))
    return _jitter_bn(p, s, np.random.default_rng(seed))


def _pyr(hws, cs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, h, w, c), dtype=np.float32) for (h, w), c in zip(hws, cs)]


def _assert_pyr_close(got, ref, tol=1e-5):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        # f32 on both sides: summation order only
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=tol, atol=tol)


def test_pyramid_widths_after_exchange():
    for ws in ([64, 32, 16], [128, 64], [512], [5, 4, 3, 2]):
        assert tmg.pyramid_widths_after_exchange(ws) == jmg.pyramid_widths_after_exchange(ws)


def test_stem7x7_matches_jax():
    jb = jmg.MgStem7x7([6, 5, 4])
    tb = load_jax_tree(tmg.MgStem7x7([6, 5, 4]).eval(), *_weights(jb, 0))
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3), dtype=np.float32)
    ref, _ = jb.apply(*_weights(jb, 0), jnp.asarray(x))
    got = tb(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == [(8, 8), (4, 4), (2, 2)]
    _assert_pyr_close(got, ref)


# (in widths, out widths, shortcut type, pyramid sizes): zero-pad widen,
# identity, 1x1 narrowing under A; B and C. The 9/5/3 pyramid's up parts
# are not exact 2x and take the materialized path.
RESIDUAL_CASES = {
    "A_widen_and_identity": ([4, 3, 2], [6, 3, 5], "A", [(8, 8), (4, 4), (2, 2)]),
    "A_narrow": ([6, 3], [4, 3], "A", [(8, 8), (4, 4)]),
    "B": ([4, 3, 2], [6, 3, 2], "B", [(9, 9), (5, 5), (3, 3)]),
    "C": ([4, 3], [4, 5], "C", [(8, 8), (4, 4)]),
    "single_scale": ([5], [5], "A", [(7, 7)]),
}


@pytest.mark.parametrize("case", sorted(RESIDUAL_CASES))
def test_residual_matches_jax(case):
    cin, cout, sc, hws = RESIDUAL_CASES[case]
    jb = jmg.MgResidual(cin, cout, shortcut_type=sc)
    tb = tmg.MgResidual(cin, cout, shortcut_type=sc).eval()
    p, s = _weights(jb, 2)
    load_jax_tree(tb, p, s)
    pyr = _pyr(hws, cin, seed=3)
    ref, _ = jb.apply(p, s, tuple(map(jnp.asarray, pyr)))
    got = tb(tuple(map(torch.from_numpy, pyr)))
    _assert_pyr_close(got, ref)


def test_residual_shortcut_choice_matches_jax():
    for cin, cout, sc in (([4, 3, 2], [6, 3, 1], "A"), ([4, 3], [6, 3], "B"), ([4], [4], "C")):
        jb = jmg.MgResidual(cin, cout, shortcut_type=sc)
        tb = tmg.MgResidual(cin, cout, shortcut_type=sc)
        assert sorted(tb.shortcuts) == [str(i) for i, m in enumerate(jb.shortcuts) if m]


@pytest.mark.parametrize("mode", ["plain", "concat"])
@pytest.mark.parametrize("hws", [[(8, 8), (4, 4), (2, 2)], [(7, 7), (4, 4), (2, 2)]])
def test_pool_matches_jax(mode, hws):
    cs = [5, 4, 3]
    pyr = _pyr(hws, cs, seed=4)
    jb = jmg.MgPool(cs, mode)
    tb = tmg.MgPool(cs, mode)
    assert tb.out_widths == jb.out_widths
    ref, _ = jb.apply({}, {}, tuple(map(jnp.asarray, pyr)))
    got = tb(tuple(map(torch.from_numpy, pyr)))
    _assert_pyr_close(got, ref, tol=0)  # a max selects: exact


def test_pool_refuses_unported_modes():
    with pytest.raises(ValueError, match="not plain, concat or drop"):
        tmg.MgPool([4, 3], "avg")
    with pytest.raises(ValueError, match="two scales"):
        tmg.MgPool([4], "concat")


def _train_grads(jblock, tblock, p, s, pyr, seed):
    """Train-mode outputs, new stats and gradients (of sum(out * r),
    with respect to the params and the input pyramid) of both blocks."""
    rng = np.random.default_rng(seed)
    jpyr = tuple(map(jnp.asarray, pyr))
    ref, _ = jblock.apply(p, s, jpyr, train=True)
    rs = [rng.standard_normal(o.shape, dtype=np.float32) for o in ref]

    def loss(p, pyr):
        out, ns = jblock.apply(p, s, pyr, train=True)
        return sum(jnp.sum(o * r) for o, r in zip(out, rs)), (out, ns)

    (_, (ref, ref_s)), (gp, gpyr) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jpyr)
    tblock.train()
    tpyr = tuple(torch.from_numpy(a).requires_grad_() for a in pyr)
    out = tblock(tpyr)
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(out, rs)).backward()
    # the port's gradients in the JAX tree's structure (a tree of one
    # tensor per parameter, as the momentum is)
    got_g = export_momentum(tblock, {"m": [q.grad for q in tblock.parameters()]})["m"]
    return (out, export_jax_tree(tblock)[1], got_g, [a.grad for a in tpyr]), (ref, ref_s, gp, gpyr)


@pytest.mark.parametrize("case", sorted(RESIDUAL_CASES))
def test_residual_train_matches_jax(case):
    """MgResidual in train mode, where stage 2 takes each same-scale part
    un-normalized through conv3x3_bn_relu_in: outputs, new running stats
    and gradients against the JAX block's custom-VJP BatchNorms."""
    cin, cout, sc, hws = RESIDUAL_CASES[case]
    jb = jmg.MgResidual(cin, cout, shortcut_type=sc)
    tb = tmg.MgResidual(cin, cout, shortcut_type=sc)
    p, s = _weights(jb, 5)
    load_jax_tree(tb, p, s)
    (out, got_s, got_g, got_gx), (ref, ref_s, gp, gx) = _train_grads(
        jb, tb, p, s, _pyr(hws, cin, seed=6), seed=7)
    _assert_pyr_close(out, ref)
    for a, b in zip(jax.tree.leaves(got_s), jax.tree.leaves(ref_s)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    # gradients through two BN backwards and up to 9*12-term sums
    assert jax.tree.structure(got_g) == jax.tree.structure(gp)
    for a, b in zip(jax.tree.leaves(got_g), jax.tree.leaves(gp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    for a, b in zip(got_gx, gx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_stem7x7_train_matches_jax():
    jb = jmg.MgStem7x7([6, 5, 4])
    p, s = _weights(jb, 8)
    tb = load_jax_tree(tmg.MgStem7x7([6, 5, 4]), p, s)
    x = np.random.default_rng(9).standard_normal((2, 32, 32, 3), dtype=np.float32)
    ref, ref_s = jb.apply(p, s, jnp.asarray(x), train=True)
    gx = jax.grad(lambda x: sum(jnp.sum(jnp.sin(o)) for o in jb.apply(p, s, x, train=True)[0]))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tb.train()(xt)
    sum(torch.sin(o).sum() for o in got).backward()
    _assert_pyr_close(got, ref)
    for a, b in zip(jax.tree.leaves(export_jax_tree(tb)[1]), jax.tree.leaves(ref_s)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "concat"])
def test_pool_grads_match_jax(mode):
    """MgPool's backward (the all-ties rule) against XLA's single-winner
    SelectAndScatter: equal where no window ties, as with continuous
    inputs; odd sizes clip their edge windows."""
    cs = [5, 4, 3]
    pyr = _pyr([(7, 7), (4, 4), (2, 2)], cs, seed=10)
    jb = jmg.MgPool(cs, mode)
    gx = jax.grad(lambda pyr: sum(jnp.sum(jnp.sin(o)) for o in jb.apply({}, {}, pyr)[0]))(
        tuple(map(jnp.asarray, pyr)))
    tpyr = tuple(torch.from_numpy(a).requires_grad_() for a in pyr)
    sum(torch.sin(o).sum() for o in tmg.MgPool(cs, mode)(tpyr)).backward()
    for a, b in zip(tpyr, gx):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_stem_pool_output_ties_at_positive_values():
    """Why the model's 2x2 pool takes the first-tie rule: the stem's
    overlapping 3x3/2 max pool copies one input maximum into neighbouring
    outputs, so block 1's down-pool sees windows tied at a positive max.
    There the Pallas kernel's all-ties rule passes k*g and XLA's one g,
    and the stem's gradients would differ from the JAX zoo's."""
    tb = tmg.MgStem7x7([6, 5, 4], generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 64, 64, 3),
                                                                   dtype=np.float32))
    with torch.no_grad():
        s0 = tb(x)[0]
    win = s0.reshape(2, 8, 2, 8, 2, 6).permute(0, 1, 3, 5, 2, 4).reshape(-1, 4)
    top = win.max(dim=-1, keepdim=True).values
    tied = ((win == top).sum(dim=-1) > 1) & (top[:, 0] > 0)
    assert int(tied.sum()) > 0
    grads = []
    for ties in ("all", "first"):
        xt = x.clone().requires_grad_()
        y = tmg.MgStem7x7([6, 5, 4], generator=torch.Generator().manual_seed(0)).train()(xt)[0]
        maxpool2(y, ties).sum().backward()
        grads.append(xt.grad)
    assert not torch.allclose(grads[0], grads[1])
