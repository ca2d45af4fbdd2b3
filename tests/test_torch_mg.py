"""The port's multigrid blocks (`mgtpu_torch.ops.mg`) against
`mgtpu.ops.mg`, in f32 on the CPU: the same numpy weights (BN affines
and running stats drawn away from their init) go into both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.ops import mg as jmg
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.utils.bridge import load_jax_tree


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
    with pytest.raises(ValueError, match="not ported"):
        tmg.MgPool([4, 3], "drop")
    with pytest.raises(ValueError, match="two scales"):
        tmg.MgPool([4], "concat")
