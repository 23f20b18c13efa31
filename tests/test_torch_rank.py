"""The port's Eq. 7 rank selection (``repro_torch.core.rank``) against the
reference's (``repro.core.rank``): the same numpy, so ranks and masks must
be equal, not close.  On ``tests/test_rank.py``'s matrices, on the smoke
configs' initial params (opt-125m-smoke selects r = 43, hymba-1.5b-smoke
r = 8), and on a small tree with a stacked zero leaf, which collapses every
rank to 1 as full-width opt-125m's stacked norm scales do.  Then the masks'
checks in ``init_factors`` and ``init_zo_state``, with the reference's
messages."""

import jax
import numpy as np
import pytest
import torch

from repro.core import rank as rrank
from repro.core.cpd import init_factors as ref_init_factors
from repro_torch.configs import get_smoke_config
from repro_torch.core import rank
from repro_torch.core.cpd import init_factors
from repro_torch.core.estimator import ZOConfig
from repro_torch.core.zo_step import init_zo_state
from repro_torch.models import build_model
from repro_torch.utils.jax_random import PRNGKey
from repro_torch.utils.tree import map_with_path


def _lowrank(m, n, r, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    if noise:
        w = w + noise * rng.standard_normal((m, n))
    return w.astype(np.float32)


def _same(got, want):
    """(ranks, masks) pairs equal: the same paths, ranks and mask bits."""
    (gr, gm), (wr, wm) = got, want
    assert gr == {p: int(r) for p, r in wr.items()}
    assert gm.keys() == wm.keys()
    for p in wm:
        np.testing.assert_array_equal(gm[p], np.asarray(wm[p]), err_msg=p)
        assert gm[p].dtype == np.float32


def _torch_tree(tree):
    return map_with_path(lambda _, a: torch.from_numpy(np.ascontiguousarray(a)), tree)


# tests/test_rank.py's cases: (function, args, kwargs)
SINGLE_CASES = {
    "exact": ("spectral_rank", (_lowrank(32, 24, 5),), dict(threshold=1e-3)),
    "eye": ("spectral_rank", (np.eye(16, dtype=np.float32),), dict(threshold=0.5)),
    "sketch": ("spectral_rank", (_lowrank(512, 384, 12, noise=1e-3),),
               dict(threshold=0.05, sketch_dim=128)),
    "sketch_tall": ("spectral_rank", (_lowrank(384, 200, 12, noise=1e-3),),
                    dict(threshold=0.05, sketch_dim=128, seed=3)),
    "batched": ("leaf_spectral_ranks",
                (np.stack([_lowrank(24, 24, 2, seed=1), _lowrank(24, 24, 7, seed=2)]),),
                dict(threshold=1e-3)),
}


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_spectral_rank_matches_reference(case):
    fn, args, kw = SINGLE_CASES[case]
    got = getattr(rank, fn)(*args, **kw)
    want = getattr(rrank, fn)(*args, **kw)
    np.testing.assert_array_equal(got, want)
    if fn == "leaf_spectral_ranks":  # a torch leaf reaches numpy as the same f32
        np.testing.assert_array_equal(getattr(rank, fn)(torch.from_numpy(args[0]), **kw), want)


def _block_params():
    return {
        "blocks": {
            "wa": np.stack([_lowrank(16, 16, 3, seed=3), _lowrank(16, 16, 6, seed=4)]),
            "wb": np.stack([_lowrank(16, 16, 5, seed=5), _lowrank(16, 16, 4, seed=6)]),
        },
        "bias": np.zeros((16,), np.float32),
    }


TREE_CASES = {
    # Eq. 7's block minimum per layer: ranks 3 and 4, a mask on each leaf
    "block_min_masks": (_block_params, dict(threshold=1e-3, r_max=64, sketch_dim=None)),
    "rmax_cap": (lambda: {"w": np.eye(32, dtype=np.float32)},
                 dict(threshold=0.5, r_max=8, sketch_dim=None)),
    "mixed_batch_shapes": (lambda: {**_block_params(), "head": _lowrank(16, 40, 9, seed=7)},
                           dict(threshold=1e-3, r_max=64, sketch_dim=None)),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_select_ranks_matches_reference(case):
    make, kw = TREE_CASES[case]
    params = make()
    got = rank.select_ranks(_torch_tree(params), **kw)
    _same(got, rrank.select_ranks(params, **kw))
    if case == "block_min_masks":
        assert set(got[0].values()) == {4} and len(got[1]) == 2
        for m in got[1].values():
            np.testing.assert_array_equal(m, [[1, 1, 1, 0], [1, 1, 1, 1]])


@pytest.mark.parametrize("arch,r", [("opt-125m", 43), ("hymba-1.5b", 8)])
def test_select_ranks_on_smoke_init_matches_reference(arch, r):
    """The smoke configs' seed-0 initial params (the port's draw is bitwise
    the reference's): every leaf at one rank, no mask."""
    params = build_model(get_smoke_config(arch), device="cpu").init(PRNGKey(0))
    got = rank.select_ranks(params)
    _same(got, rrank.select_ranks(map_with_path(lambda _, w: w.numpy(), params)))
    assert set(got[0].values()) == {r} and got[1] == {}


def test_stacked_zero_leaf_collapses_every_rank_to_one():
    """A stacked [L, D] zero leaf with L >= 8 is a matrix of rank 1, and with
    no layer digit in any path every leaf shares its block's scalar minimum:
    full-width opt-125m's stacked norm scales at init do this."""
    params = {
        "blocks": {"ln1": np.zeros((8, 48), np.float32),
                   "wq": np.stack([_lowrank(48, 48, 20, seed=i) for i in range(8)])},
        "embed": _lowrank(96, 48, 30, seed=9),
    }
    got = rank.select_ranks(_torch_tree(params), threshold=0.25)
    _same(got, rrank.select_ranks(params, threshold=0.25))
    assert got[0] == {"['blocks']['ln1']": 1, "['blocks']['wq']": 1, "['embed']": 1}
    assert got[1] == {}
    assert rank.spectral_rank(params["embed"], 0.25) > 1  # alone it is not rank 1


def test_init_factors_takes_the_mask_and_checks_its_shape():
    params = {"blocks": {"wq": torch.zeros(2, 16, 16)}}
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    f = init_factors(params, PRNGKey(1), default_rank=4, rank_masks={"['blocks']['wq']": mask})
    got = f["['blocks']['wq']"].rank_mask
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), mask)
    with pytest.raises(AssertionError) as port:
        init_factors(params, PRNGKey(1), default_rank=4, rank_masks={"['blocks']['wq']": mask[0]})
    with pytest.raises(AssertionError) as ref:
        ref_init_factors({"blocks": {"wq": np.zeros((2, 16, 16), np.float32)}},
                         jax.random.PRNGKey(1),
                         default_rank=4, rank_masks={"['blocks']['wq']": mask[0]})
    assert str(port.value) == str(ref.value)


def test_masks_with_weight_quant_are_rejected():
    """The reference's rejection of per-path ranks or masks with quantized
    leaves, from init_zo_state, and of a mask on a QuantLeaf in
    init_factors."""
    model = build_model(get_smoke_config("opt-125m"), device="cpu")
    zc = ZOConfig(method="tezo_adam", weight_quant="lut4", rank=8)
    mask = {"['blocks']['wq']": np.ones((2, 8), np.float32)}
    with pytest.raises(ValueError, match="per-path ranks/rank_masks is unsupported"):
        init_zo_state(model.init(PRNGKey(0)), zc, rank_masks=mask)
    quantized = init_zo_state(model.init(PRNGKey(0)), zc).params
    with pytest.raises(ValueError, match=r"rank_masks on quantized leaf \['blocks'\]\['wq'\]"):
        init_factors(quantized, PRNGKey(0), default_rank=8, rank_masks=mask)
