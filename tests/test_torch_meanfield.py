"""The port's mean field against the JAX package's (MXU grid in Pallas
interpret mode, f32 state), and its routing against the TPU routing.

The reference's fused-path tests use bi_sxy=28; on the TPU's compiled
path that config does not take the grid (28-px cells are not 8-aligned),
so the port refuses it (test_non_grid_configs_raise) and the parity test
runs bi_sxy=40, which takes the same downsampled-message path (8-px cells
on a 22x22 guide with padded tiles).

Tolerances: the reference rounds its grid and filter input/output to
bf16.  The f32 port: labels agree >= 0.995, Q within 1.5e-2 (measured
0.9987 and 7.2e-3).  With the reference-rounding switch: labels >= 0.999,
Q within 1e-3 (measured 1.0 and 1.9e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu.ops.crf import mxu_grid as jax_grid
from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.ops.crf import meanfield as mf

SIZE = 112
CFG = (1.5, 3, 40.0, 40.0, 10.0, 2)


@pytest.fixture(scope='module')
def parity_case():
    rng = np.random.default_rng(0)
    b, c = 3, 4
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.normal(0, 2, (b, SIZE, SIZE, c)).astype(np.float32))))
    imgs = rng.uniform(0, 255, (b, SIZE, SIZE, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)
        want = np.asarray(jax_mf.mean_field(
            jnp.asarray(probs), jnp.asarray(imgs),
            jax_config.CRFConfig(*CFG)))
    return np.array(probs), imgs, want


@pytest.mark.parametrize('ref_round,min_agree,q_atol', [
    (False, 0.995, 1.5e-2), (True, 0.999, 1e-3)])
def test_mean_field_matches_jax(parity_case, ref_round, min_agree, q_atol):
    probs, imgs, want = parity_case
    got = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(imgs),
                        config.CRFConfig(*CFG), ref_round=ref_round).numpy()
    assert got.shape == want.shape
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= min_agree, agree
    np.testing.assert_allclose(got, want, atol=q_atol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_single_image_form(parity_case):
    probs, imgs, _ = parity_case
    cfg = config.CRFConfig(*CFG)
    batched = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(imgs),
                            cfg)
    one = mf.mean_field(torch.from_numpy(probs[1]), torch.from_numpy(imgs[1]),
                        cfg)
    np.testing.assert_allclose(one.numpy(), batched[1].numpy(), atol=1e-6)


def test_gaussian_filter_matches_jax():
    x = np.random.default_rng(1).normal(0, 1, (2, 20, 23, 3)
                                        ).astype(np.float32)
    want = np.asarray(jax_mf._gaussian_filter_raw(jnp.asarray(x), 1.5,
                                                  axes=(1, 2)))
    got = mf._gaussian_filter_raw(torch.from_numpy(x), 1.5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(mf._gauss_band(20, 1.5),
                                  jax_mf._gauss_band(20, 1.5))


def _production_cases():
    """(config, hw, n_ch) for every table of ops/crf/config.py at the
    size its stack runs: HSN / SEC / DSRG test CRFs on 321^2 VOC
    (21 classes) or DeepGlobe (6), ADP at 1088^2, the SEC/DSRG train CRF
    on the 41^2 seed grid, IRNet's label CRF at 300^2."""
    sizes = {'VOC2012': ((321, 321), 21), 'DeepGlobe': ((321, 321), 6),
             'DeepGlobe_balanced': ((321, 321), 6),
             'ADP-morph': ((1088, 1088), 10), 'ADP-func': ((1088, 1088), 5)}
    cases = []
    for (ds, _), cfg in config.HSN_TEST.items():
        cases.append((cfg,) + sizes[ds])
    for ds, cfg in config.SEC_TEST.items():
        cases.append((cfg,) + sizes[ds])
    cases += [(config.DSRG_TEST, (321, 321), 21),
              (config.SEC_TRAIN_DEFAULT, (41, 41), 21),
              (config.DSRG_TRAIN, (41, 41), 21),
              (config.IRN_LABEL, (300, 300), 21)]
    return cases


def test_routing_follows_tpu_routing():
    assert config.HSN_TEST == {
        k: config.CRFConfig(*v.astuple())
        for k, v in jax_config.HSN_TEST.items()}
    cases = _production_cases()
    grid_routed = 0
    for cfg, hw, n_ch in cases:
        want = bool(cfg.bi_compat) and jax_mf._routes_to_grid(
            hw, cfg.bi_sxy, cfg.bi_srgb) and jax_grid.applicable(
            cfg.bi_sxy, cfg.bi_srgb, n_ch, jax_mf.MXU_CELL_MULT,
            require8=True)
        assert mf._mxu_ok(hw, n_ch, cfg) == want, (cfg, hw, n_ch)
        grid_routed += want
    assert mf._mxu_ok((321, 321), 21, config.hsn_config('VOC2012', 'VGG16'))
    assert 0 < grid_routed < len(cases)


@pytest.mark.parametrize('cfg,hw,n_ch', [
    (config.hsn_config('ADP-morph'), (1088, 1088), 10),   # sxy 10: window
    (config.CRFConfig(1.5, 3, 28.0, 40.0, 10.0, 2), (SIZE, SIZE), 4),
    (config.SEC_TRAIN_DEFAULT, (41, 41), 21),              # dense kernel
])
def test_non_grid_configs_raise(cfg, hw, n_ch):
    probs = torch.full(hw + (n_ch,), 1.0 / n_ch)
    img = torch.zeros(hw + (3,))
    with pytest.raises(NotImplementedError, match='queue 1 item 8'):
        mf.mean_field(probs, img, cfg)
