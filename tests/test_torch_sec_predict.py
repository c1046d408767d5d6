"""The port's SEC/DSRG prediction end to end against the JAX package's
predict loop body (wsss_tpu/cli/sec_dsrg.py:225-249, transcribed below
with the JAX functions; Pallas kernels in interpret mode), on bridged
weights and the same numpy image:

  * SEC on VOC2012: native 150x170, ground truth 168x176, network size
    65 — the CRF runs at 168x176 on a 17x18 guide (8-px cells), routed
    to the bilateral grid as at full size;
  * DSRG on DeepGlobe: network size 161, CRF at network resolution, the
    argmax nearest-resized to the ground truth's 200x190.

Tolerance: label agreement >= 0.99 for the f32 port (the reference's
grid and filter input/output are bf16, so pixels near a tie may flip)
and >= 0.999 with the reference-rounding switch.  A 33-class mean field
(v1 route without a switch: unfused message grid, fused C=1 grid) is
held to the reference the same way; the confusion matrix and IoU equal
the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_deeplab import bridged_deeplab
from wsss_tpu.cli import sec_dsrg as jax_cli
from wsss_tpu.data import registry as jax_registry
from wsss_tpu.eval import metrics as jax_metrics
from wsss_tpu.methods.gradcam_cues import _normalizer as jax_normalizer
from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu.ops.filters import resize_bilinear as jax_resize_bilinear
from wsss_tpu_torch.cli import sec_dsrg as cli
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.eval import metrics
from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.ops.crf import meanfield as mf


@pytest.fixture
def interpret_mxu(monkeypatch):
    monkeypatch.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)


def _jax_predict(fwd, dataset, method, native, out_hw, size):
    """cli/sec_dsrg.py:214-249 for one image, `fwd` the jitted FCN."""
    norm = jax_normalizer(jax_registry.get(dataset).norm_sec)
    cfg = (jax_config.SEC_TEST.get(dataset, jax_config.DSRG_TEST)
           if method == 'SEC' else jax_config.DSRG_TEST)
    net_in = np.asarray(jax.image.resize(
        jnp.asarray(native), (size, size, 3), 'bilinear'))
    logits = fwd(jnp.asarray(norm(net_in[None])))
    probs = jax.nn.softmax(
        jax_resize_bilinear(logits, (size, size)), axis=-1)
    if 'DeepGlobe' not in dataset:
        probs = jnp.clip(jax_resize_bilinear(probs, out_hw), 1e-8, 1.0)
        probs = probs / probs.sum(-1, keepdims=True)
        guide = (native if native.shape[:2] == out_hw else
                 np.asarray(jax.image.resize(
                     jnp.asarray(native), out_hw + (3,), 'bilinear')))
        q = jax_mf.mean_field(probs, jnp.asarray(guide, jnp.float32)[None],
                              cfg)
        return np.asarray(jnp.argmax(q, -1))[0]
    q = jax_mf.mean_field(probs, jnp.asarray(net_in, jnp.float32)[None],
                          cfg)
    pred = np.asarray(jnp.argmax(q, -1))[0]
    if pred.shape != out_hw:
        pred = np.asarray(jax.image.resize(
            jnp.asarray(pred, jnp.float32)[..., None],
            out_hw + (1,), 'nearest'))[..., 0].astype(np.int32)
    return pred


def _blocky_image(rng, hw):
    """Flat colour patches plus noise: a guide with real edges."""
    h, w = hw
    base = rng.integers(0, 256, (-(-h // 24), -(-w // 24), 3))
    img = np.kron(base, np.ones((24, 24, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).round(
        ).astype(np.float32)


@pytest.mark.parametrize('method,dataset,native_hw,out_hw,size', [
    ('SEC', 'VOC2012', (150, 170), (168, 176), 65),
    ('DSRG', 'DeepGlobe', (180, 200), (200, 190), 161),
])
def test_predict_image_matches_jax(interpret_mxu, method, dataset,
                                   native_hw, out_hw, size):
    spec = registry.get(dataset)
    n_cls = spec.n_seg_classes
    fwd, _, pred = bridged_deeplab(method, n_cls, size, seed=3)
    native = _blocky_image(np.random.default_rng(7), native_hw)
    want = _jax_predict(fwd, dataset, method, native, out_hw, size)
    assert want.shape == out_hw
    assert len(np.unique(want)) > 1
    for ref_round, floor in ((False, 0.99), (True, 0.999)):
        got = cli.predict_image(pred, spec, method, native, out_hw,
                                size=size, ref_round=ref_round)
        assert got.dtype == torch.int32 and tuple(got.shape) == out_hw
        got = got.numpy()
        assert got.min() >= 0 and got.max() < n_cls
        agree = (got == want).mean()
        print(f'{method} {dataset} ref_round={ref_round}: '
              f'label agreement {agree:.6f}')
        assert agree >= floor, (ref_round, agree)


def test_wide_mean_field_matches_jax(interpret_mxu):
    """33 classes at a grid-routed config: the message grid takes the v1
    unfused route and the C=1 normalizer grid the fused one, in the
    reference and in the port, with no switch."""
    rng = np.random.default_rng(11)
    hw, c = (168, 176), 33
    probs = np.array(jax.nn.softmax(jnp.asarray(
        rng.normal(0, 2, (1,) + hw + (c,)).astype(np.float32))))
    imgs = _blocky_image(rng, hw)[None]
    cfg = config.SEC_TEST['VOC2012'].astuple()[:5] + (2,)
    assert mf._mxu_ok(hw, c, config.CRFConfig(*cfg))
    want = np.asarray(jax_mf.mean_field(
        jnp.asarray(probs), jnp.asarray(imgs), jax_config.CRFConfig(*cfg)))
    for ref_round, floor, q_atol in ((False, 0.99, 1.5e-2),
                                     (True, 0.999, 1e-3)):
        got = mf.mean_field(torch.from_numpy(probs), torch.from_numpy(imgs),
                            config.CRFConfig(*cfg),
                            ref_round=ref_round).numpy()
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        print(f'wide ref_round={ref_round}: agreement {agree:.6f}, '
              f'max |dQ| {np.abs(got - want).max():.2e}')
        assert agree >= floor, (ref_round, agree)
        np.testing.assert_allclose(got, want, atol=q_atol)


def test_confusion_and_iou_match_jax():
    rng = np.random.default_rng(13)
    n = 6
    pred = rng.integers(-1, n + 2, (40, 50)).astype(np.int32)
    gt = rng.integers(0, n, (40, 50)).astype(np.int32)
    gt[rng.uniform(size=gt.shape) < 0.1] = 255
    gt[0, :3] = (-1, n, n + 3)
    want = np.asarray(jax_metrics.confusion_matrix(
        jnp.asarray(pred), jnp.asarray(gt), n))
    got = metrics.confusion_matrix(torch.from_numpy(pred),
                                   torch.from_numpy(gt), n)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = metrics.accumulate_confusion(
        np.zeros((n, n), np.int64), torch.from_numpy(pred),
        torch.from_numpy(gt), n)
    acc = metrics.accumulate_confusion(acc, torch.from_numpy(pred),
                                       torch.from_numpy(gt), n)
    assert acc.dtype == np.int64
    np.testing.assert_array_equal(acc, 2 * want)
    acc[:, 2] = 0
    acc[2, :] = 0                       # an absent class drops out of mIoU
    iou_w, miou_w = jax_metrics.iou_from_confusion(acc)
    iou_g, miou_g = metrics.iou_from_confusion(torch.from_numpy(acc))
    np.testing.assert_array_equal(iou_g, iou_w)
    assert miou_g == miou_w


def test_cli_constants_and_main(tmp_path, monkeypatch, capsys):
    assert cli.SEED_SIZE == jax_cli.SEED_SIZE
    assert cli.SWEEP_DEFAULTS == jax_cli.SWEEP_DEFAULTS
    assert (cli.predict_crf_config('VOC2012', 'SEC').astuple()
            == jax_config.SEC_TEST['VOC2012'].astuple())
    assert (cli.predict_crf_config('ADP-func', 'DSRG').astuple()
            == jax_config.DSRG_TEST.astuple())
    # --task train is the default, as in the reference: on the card unless
    # the CPU is asked for; the tasks are held against the JAX CLI in
    # tests/test_torch_cli_hsn_sec.py and tests/test_torch_cli_train.py
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            cli.main([])
    monkeypatch.chdir(tmp_path)
    cli.main(['--device', 'cpu', '--img_size', '24', '--synthetic_n', '2',
              '--batchsize', '2', '--epochs', '1'])
    assert 'trained SEC_VOC2012_VGG16 for 1 steps' in capsys.readouterr().out
