"""The port's mean field against the JAX package's (MXU grid in Pallas
interpret mode, f32 state), and its routing against the TPU routing.

The reference's fused-path tests use bi_sxy=28; on the TPU's compiled
path that config does not take the grid (28-px cells are not 8-aligned),
so the port runs it on the scatter grid as the reference's TPU path
does (test_non_grid_configs_run_on_reference_structure) and the parity
test runs bi_sxy=40, which takes the same downsampled-message path
(8-px cells on a 22x22 guide with padded tiles).

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


@pytest.mark.parametrize('cfg,hw,n_ch,kind,small,small_sxy', [
    (config.hsn_config('ADP-morph'), (1088, 1088), 10, 'direct',
     (104, 100), 2.0),           # sxy 10: window; run with 113 offsets
    (config.CRFConfig(1.5, 3, 28.0, 40.0, 10.0, 2), (SIZE, SIZE), 4, 'grid',
     (SIZE, SIZE), 28.0),                                  # scatter grid
    (config.SEC_TRAIN_DEFAULT, (41, 41), 21, 'dense', (41, 41), 80 / 12),
], ids=['direct', 'grid', 'dense'])
def test_non_grid_configs_run_on_reference_structure(cfg, hw, n_ch, kind,
                                                     small, small_sxy):
    """Configs that do not land on the MXU-layout grid get the structure
    the reference picks for them, and run (here at a size and a
    bilateral sxy that keep that structure cheap on the CPU, one
    iteration; tests/test_torch_crf_structures.py holds each structure's
    values to the reference)."""
    assert not mf._mxu_ok(hw, n_ch, cfg)
    assert mf.bilateral_structure(hw, cfg.bi_sxy, cfg.bi_srgb) == kind
    run = config.CRFConfig(cfg.g_sxy, cfg.g_compat, small_sxy, cfg.bi_srgb,
                           cfg.bi_compat, 1)
    assert mf.bilateral_structure(small, run.bi_sxy, run.bi_srgb) == kind
    assert not mf._mxu_ok(small, n_ch, run)
    rng = np.random.default_rng(3)
    probs = torch.from_numpy(rng.dirichlet(np.ones(n_ch), small)
                             .astype(np.float32))
    img = torch.from_numpy(rng.uniform(0, 255, small + (3,))
                           .astype(np.float32))
    q = mf.mean_field(probs, img, run)
    assert q.shape == probs.shape and torch.isfinite(q).all()
    np.testing.assert_allclose(q.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float((q - probs).abs().max()) > 1e-3
