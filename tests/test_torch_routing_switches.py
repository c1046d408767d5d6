"""The reference's two routing switches in the port's ``mean_field``.

``WSSS_TPU_NO_MXU`` keeps every config off the MXU-layout grid (the
reference's ``_mxu_ok``, wsss_tpu/ops/crf/meanfield.py:520), and
``WSSS_TPU_NO_SPATIAL_DS`` runs the grid's bilateral message at full
resolution (``use_ds``, :564).  Both are read at import into
``_MXU_DISABLED`` / ``_MXU_DS_DISABLED`` with the reference's truthiness
(any non-empty value); the tests flip the flags of both packages and
hold the port's ``mean_field`` to the reference's (its Pallas kernels in
interpret mode).

Tolerances.  Off the grid the config runs on the scatter grid, which the
reference fills in bf16: with the port's rounding switch Q within 1e-4
(tests/test_torch_crf_structures.py).  On the grid at full resolution,
the f32 port as tests/test_torch_meanfield.py holds it: labels >= 0.995,
Q within 1.5e-2.  (Its rounding switch is not held to 1e-3 here: on
24-px tiles the port's f32 sums and the reference's matrix-unit sums of
a partial round to bf16 one ulp apart at a few cells, and the mean field
carries that past 1e-3 in Q.)"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.ops.crf import meanfield as mf


def _problem(hw, c, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2,) + hw + (c,)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    imgs = rng.uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
    return probs, imgs


def _reference(probs, imgs, cfg):
    return np.asarray(jax_mf.mean_field(
        jnp.asarray(probs), jnp.asarray(imgs),
        jax_config.CRFConfig(*cfg.astuple())))


def test_no_mxu_switch_matches_jax(monkeypatch):
    """A grid config takes the reference's own structure (the scatter
    grid) in both packages once the switch is set."""
    cfg = config.CRFConfig(1.5, 3, 40.0, 40.0, 10.0, 2)
    hw = (112, 104)
    probs, imgs = _problem(hw, 3, 0)
    monkeypatch.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)
    assert mf._mxu_ok(hw, 3, cfg)
    monkeypatch.setattr(jax_mf, '_MXU_DISABLED', True)
    monkeypatch.setattr(mf, '_MXU_DISABLED', True)
    monkeypatch.setattr(mf, '_NATIVE_DISABLED', True)
    assert not mf._mxu_ok(hw, 3, cfg)
    assert not jax_mf._mxu_ok(hw, 3, jax_config.CRFConfig(*cfg.astuple()))
    assert mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb) == 'grid'

    def no_grid(*args, **kw):
        raise AssertionError('the MXU-layout grid ran under WSSS_TPU_NO_MXU')
    monkeypatch.setattr(mf, '_mean_field_mxu', no_grid)
    want = _reference(probs, imgs, cfg)
    got = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(imgs), cfg,
                        ref_round=True).numpy()
    err = np.abs(got - want).max()
    print(f'WSSS_TPU_NO_MXU: max |dQ| {err:.3e}')
    assert err <= 1e-4
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_no_spatial_ds_switch_matches_jax(monkeypatch):
    """sxy 24 on a 112x104 image: the message is downsampled (8-px cells
    on a 37x35 guide) without the switch and runs at full resolution
    (24-px cells: t 24, whose bilinear weights are no powers of two) with
    it."""
    from wsss_tpu_torch.ops.crf import mxu_grid
    cfg = config.CRFConfig(1.5, 3, 24.0, 40.0, 10.0, 2)
    hw = (112, 104)
    probs, imgs = _problem(hw, 3, 1)
    monkeypatch.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)
    built = []
    grid_cls = mxu_grid.MXUBilateralGrid

    class Spy(grid_cls):
        def __init__(self, img, sxy, *args, **kw):
            built.append((tuple(img.shape[1:3]), sxy))
            super().__init__(img, sxy, *args, **kw)
    monkeypatch.setattr(mxu_grid, 'MXUBilateralGrid', Spy)
    x = (torch.from_numpy(probs), torch.from_numpy(imgs))
    downsampled = mf.mean_field(*x, cfg).numpy()
    assert built[0] == ((37, 35), 8.0)
    monkeypatch.setattr(jax_mf, '_MXU_DS_DISABLED', True)
    monkeypatch.setattr(mf, '_MXU_DS_DISABLED', True)
    built.clear()
    got = mf.mean_field(*x, cfg).numpy()
    assert built[0] == (hw, 24.0)
    want = _reference(probs, imgs, cfg)
    err = np.abs(got - want).max()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    print(f'WSSS_TPU_NO_SPATIAL_DS: max |dQ| {err:.3e}, labels agree '
          f'{agree:.5f}')
    assert err <= 1.5e-2 and agree >= 0.995
    # the switch is live: full resolution gives another posterior
    assert np.abs(got - downsampled).max() > 1e-3


@pytest.mark.parametrize('no_mxu,no_ds', [('1', ''), ('', 'yes'),
                                          ('0', '1')])
def test_switches_are_read_from_the_environment_at_import(no_mxu, no_ds):
    """A fresh interpreter reads both variables at import, with the
    reference's truthiness (any non-empty value, '0' too), into the same
    flags as the reference."""
    env = dict(os.environ, WSSS_TPU_NO_MXU=no_mxu,
               WSSS_TPU_NO_SPATIAL_DS=no_ds, JAX_PLATFORMS='cpu')
    code = ('from wsss_tpu_torch.ops.crf import meanfield as mf\n'
            'from wsss_tpu.ops.crf import meanfield as ref\n'
            'print(mf._MXU_DISABLED, mf._MXU_DS_DISABLED, '
            'ref._MXU_DISABLED, ref._MXU_DS_DISABLED)\n')
    out = subprocess.run([sys.executable, '-c', code], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    want = str(bool(no_mxu)), str(bool(no_ds))
    assert out == list(want) * 2, out
