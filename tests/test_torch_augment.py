"""The port's copy of the augmentation module against the JAX package's:
every function, and each dataset's classifier_augment, gives the same
arrays under the same np.random.Generator (and leaves the generator in
the same state)."""
import numpy as np
import pytest

from wsss_tpu.data import augment as ref
from wsss_tpu_torch.data import augment as ours


def _img(h=37, w=29, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, c)).astype(
        np.float32)


def _lab(h=37, w=29, seed=1):
    return np.random.default_rng(seed).integers(0, 21, (h, w)).astype(
        np.int32)


CASES = {
    'pil_rescale': lambda m, g: [m.pil_rescale(_img(), 0.7, 3),
                                 m.pil_rescale(_lab(), 1.3, 0)],
    'pil_resize': lambda m, g: [m.pil_resize(_img(), (20, 41), 1),
                                m.pil_resize(_lab(), (20, 41), 0)],
    'random_resize_long': lambda m, g: [
        m.random_resize_long(_img(), 30, 60, g) for _ in range(3)],
    'random_scale': lambda m, g: m.random_scale(
        [_img(), _lab()], (0.5, 1.5), (3, 0), g),
    'random_lr_flip': lambda m, g: sum(
        (m.random_lr_flip([_img(), _lab()], g) for _ in range(4)), []),
    'random_ud_flip': lambda m, g: sum(
        (m.random_ud_flip([_img(), _lab()], g) for _ in range(4)), []),
    'random_crop': lambda m, g: (m.random_crop([_img(), _lab()], 24,
                                               (0, 255), g)
                                 + m.random_crop([_img(), _lab()], 48,
                                                 (0, 255), g)),
    'top_left_crop': lambda m, g: [m.top_left_crop(_img(), 24, 0),
                                   m.top_left_crop(_lab(), 48, 255)],
    'random_affine': lambda m, g: [m.random_affine(
        _img(), g, rotation_deg=30.0, shift_frac=0.1, zoom_frac=0.2)],
}


def _run(mod, case, seed=3):
    g = np.random.default_rng(seed)
    out = CASES[case](mod, g)
    return out, g.random()


@pytest.mark.parametrize('case', sorted(CASES))
def test_function_equals_jax_package(case):
    got, g_next = _run(ours, case)
    want, w_next = _run(ref, case)
    assert g_next == w_next
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('dataset', ['VOC2012', 'DeepGlobe', 'ADP-morph',
                                     'ADP-func'])
@pytest.mark.parametrize('with_gt', [False, True])
def test_classifier_augment_equals_jax_package(dataset, with_gt):
    f_ours, f_ref = (m.classifier_augment(dataset) for m in (ours, ref))
    g_ours, g_ref = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(4):
        img, gt = _img(seed=i), (_lab(seed=i) if with_gt else None)
        a_img, a_gt = f_ours(img, gt, g_ours)
        b_img, b_gt = f_ref(img, gt, g_ref)
        np.testing.assert_array_equal(a_img, b_img)
        if with_gt:
            np.testing.assert_array_equal(a_gt, b_gt)
        else:
            assert a_gt is None and b_gt is None
    assert g_ours.random() == g_ref.random()
