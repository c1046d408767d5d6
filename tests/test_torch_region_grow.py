"""The port's DSRG region growing against the JAX package's flood fill and
the scipy oracle of ``tests/test_region_grow.py`` (the reference's
connected-component semantics, DSRG.py:7-62), on the same seeded cases:
the grown cues must be equal, element for element."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_region_grow import _random_case, np_region_grow_single
from wsss_tpu.ops.region_grow import region_grow as jax_region_grow
from wsss_tpu_torch.ops import region_grow as rg


def _both(cue, prob, tag, **kw):
    got = rg.region_grow(torch.from_numpy(cue), torch.from_numpy(prob),
                         torch.from_numpy(tag), **kw).numpy()
    want = np.asarray(jax_region_grow(jnp.asarray(cue), jnp.asarray(prob),
                                      jnp.asarray(tag), **kw))
    return got, want


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('hw,c', [((12, 12), 4), ((9, 15), 6)])
def test_random_cases_equal_jax_and_oracle(seed, hw, c):
    tag, cue, prob = _random_case(seed, b=3, h=hw[0], w=hw[1], c=c)
    got, want = _both(cue, prob, tag)
    np.testing.assert_array_equal(got, want)
    oracle = np.stack([np_region_grow_single(tag[i], cue[i], prob[i])
                       for i in range(cue.shape[0])])
    np.testing.assert_array_equal(got, oracle)


def test_conflicting_cues_and_sequential_classes():
    """Class 1 grows first and claims the free pixels it reaches; class 2
    then finds them cued elsewhere; a pixel cued to class 2 is never
    taken by class 1.  Both packages and the oracle agree."""
    h = w = 7
    c = 3
    prob = np.zeros((1, h, w, c), np.float32)
    prob[..., 1] = 0.6
    prob[..., 2] = 0.55
    prob[0, :, 4:, 2] = 0.9                      # class 2 wins on the right
    prob[..., 0] = 1 - prob[..., 1:].max(-1)
    cue = np.zeros((1, h, w, c), np.float32)
    cue[0, 3, 1, 1] = 1
    cue[0, 3, 2, 2] = 1                          # conflicting seed
    cue[0, 0, 6, 2] = 1
    tag = np.ones((1, c), np.float32)
    got, want = _both(cue, prob, tag)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[0], np_region_grow_single(tag[0], cue[0], prob[0]))
    assert got[0, 3, 2, 2] == 1 and got[0, 3, 2, 1] == 0
    assert got[0, 0, 0, 1] == 1 and got[0, 6, 6, 2] == 1


def test_untagged_classes_are_skipped_and_thresholds_pass_through():
    """A class no image is tagged with keeps its cues; th_f / th_b reach
    the fill as in the reference."""
    tag, cue, prob = _random_case(7, b=2, h=10, w=10, c=5)
    tag[:, 4] = 0
    cue[0, 0, 0] = 0
    cue[0, 0, 0, 4] = 1                          # a cue of an untagged class
    for kw in ({}, {'th_f': 0.3, 'th_b': 0.4}):
        got, want = _both(cue, prob, tag, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[..., 4], cue[..., 4])


def test_fixpoint_checked_between_dilation_runs(monkeypatch):
    """The count is read once every CHECK_EVERY dilations: a spiral that
    needs dozens of dilations grows the same with the check after every
    one and after every 8."""
    h = w = 15
    mask = np.zeros((h, w), bool)
    mask[1, 1:14] = mask[1:14, 13] = mask[13, 1:14] = True
    mask[3:14, 1] = mask[3, 1:12] = mask[3:12, 11] = True
    prob = np.zeros((1, h, w, 2), np.float32)
    prob[..., 0] = 0.95
    prob[0][mask] = [0.05, 0.95]
    cue = np.zeros((1, h, w, 2), np.float32)
    cue[0, 1, 1, 1] = 1
    tag = np.ones((1, 2), np.float32)
    every8, want = _both(cue, prob, tag)
    monkeypatch.setattr(rg, 'CHECK_EVERY', 1)
    every1, _ = _both(cue, prob, tag)
    np.testing.assert_array_equal(every8, want)
    np.testing.assert_array_equal(every1, want)
    assert every8[0, ..., 1].sum() == mask.sum()
