"""The port's 03b command line (``wsss_tpu_torch/cli/irn.py``) against
the JAX package's, over the five inference passes make_cam, eval_cam,
cam_to_ir_label, make_sem_seg and eval_sem_seg, on the same synthetic
VOC2012 split (3 images around 64^2, scales 1.0 and 0.5) with the same
classifier triplet (written by the JAX package) and the same IRNet
weights: an orbax checkpoint for the JAX CLI, a ``torch.save``
checkpoint of the bridged module for the port's.

What is held: the cam .npy dicts (keys equal, maps within 1e-4), the
ir-label PNGs (>= 0.99 of the pixels: the CRF's float32 sums differ in
order between the packages), the sem-seg PNGs (>= 0.999), both mIoUs
within 1e-3; and that asking for IRNet training raises
NotImplementedError before anything is written."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import perturbed_variables
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.cli import irn as jax_irn_cli
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.models.irn import IRNet as JIRNet
from wsss_tpu_torch.cli import irn as irn_cli
from wsss_tpu_torch.io import checkpoint
from wsss_tpu_torch.io.flax_bridge import load_flax_irnet
from wsss_tpu_torch.models.irn import IRNet

SIZE = 64
PASSES = 'make_cam,eval_cam,cam_to_ir_label,make_sem_seg,eval_sem_seg'
CAM_TOL = 1e-4
IR_FLOOR = 0.99
SEM_FLOOR = 0.999
MIOU_TOL = 1e-3
RUN = 'IRN_VOC2012_VGG16'
DISP_MEAN = np.array([0.1, -0.2], np.float32)


def _argv(root):
    return ['--dataset', 'VOC2012', '--model', 'VGG16', '--img_size',
            str(SIZE), '--synthetic_n', '3', '--batchsize', '2',
            '--scales', '1.0,0.5', '--model_root', str(root / 'models'),
            '--work_root', str(root / 'work'), '--passes', PASSES,
            '--saveimg']


def _irn_variables():
    """IRNet (vgg16) flax variables, biases and norms perturbed."""
    model = JIRNet(backbone='vgg16')
    variables = jax.jit(model.init)(jax.random.PRNGKey(5),
                                    jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(5)

    def perturb(path, a):
        a = np.array(a, np.float32)
        if 'kernel' in jax.tree_util.keystr(path):
            return a
        return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """(JAX root, JAX result, port root, port result): each CLI once."""
    jroot = tmp_path_factory.mktemp('jax')
    _, clf = perturbed_variables('VGG16', 20, SIZE, seed=6)
    sid = 'VOC2012_VGG16'
    jax_ckpt.export_triplet(str(jroot / 'models' / sid), sid,
                            {'model': 'VGG16'}, clf['params'],
                            thresholds=np.full(20, 0.5, np.float32))
    irn_vars = _irn_variables()
    jax_ckpt.save_checkpoint(
        str(jroot / 'work' / RUN / 'irn_ckpt'), 0,
        {'variables': jax.tree_util.tree_map(jnp.asarray, irn_vars),
         'disp_mean': jnp.asarray(DISP_MEAN)})
    jres = jax_irn_cli.main(_argv(jroot))
    proot = tmp_path_factory.mktemp('port')
    os.symlink(jroot / 'models', proot / 'models')
    net = load_flax_irnet(IRNet('vgg16'), irn_vars)
    checkpoint.save_checkpoint(
        str(proot / 'work' / RUN / 'irn_ckpt'), 0,
        {'variables': net.state_dict(),
         'disp_mean': torch.from_numpy(DISP_MEAN)})
    pres = irn_cli.main(_argv(proot) + ['--device', 'cpu'])
    return jroot, jres, proot, pres


def _files(root, sub, ext):
    d = root / 'work' / RUN / sub
    return sorted(f for f in os.listdir(d) if f.endswith(ext))


def test_cam_dicts_equal_jax(runs):
    jroot, _, proot, _ = runs
    names = _files(jroot, 'cam', '.npy')
    assert names == _files(proot, 'cam', '.npy') and len(names) == 3
    for n in names:
        want = np.load(jroot / 'work' / RUN / 'cam' / n,
                       allow_pickle=True).item()
        got = np.load(proot / 'work' / RUN / 'cam' / n,
                      allow_pickle=True).item()
        assert sorted(got) == sorted(want)
        np.testing.assert_array_equal(got['keys'], want['keys'])
        for k in ('cam', 'high_res'):
            d = float(np.abs(got[k] - want[k]).max())
            print(f'{n} {k} {got[k].shape}: max |diff| {d:.3e}')
            assert got[k].shape == want[k].shape and d <= CAM_TOL


@pytest.mark.parametrize('sub,floor', [('ir_label', IR_FLOOR),
                                       ('sem_seg', SEM_FLOOR)])
def test_label_pngs_agree_with_jax(runs, sub, floor):
    jroot, _, proot, _ = runs
    names = _files(jroot, sub, '.png')
    assert names == _files(proot, sub, '.png') and len(names) == 3
    for n in names:
        want = np.asarray(Image.open(jroot / 'work' / RUN / sub / n))
        got = np.asarray(Image.open(proot / 'work' / RUN / sub / n))
        agree = (got == want).mean()
        print(f'{sub}/{n} {want.shape}: agreement {agree:.6f}, labels '
              f'{np.unique(want).tolist()}')
        assert got.shape == want.shape and agree >= floor
    assert (_files(jroot, sub + '_clr', '.png')
            == _files(proot, sub + '_clr', '.png'))


def test_mious_equal_jax(runs):
    _, jres, proot, pres = runs
    print(f'port {pres}, JAX {jres}')
    assert sorted(pres) == sorted(jres) == ['cam_miou', 'miou']
    for k in jres:
        assert abs(pres[k] - jres[k]) <= MIOU_TOL
    for csv in ('cam_iou.csv', 'sem_seg_iou.csv'):
        assert (proot / 'work' / RUN / 'eval' / csv).stat().st_size


@pytest.mark.parametrize('extra', [['--passes', 'train_irn'], [],
                                   ['--tune'],
                                   ['--passes', 'make_cam,train_irn']])
def test_training_is_refused_before_writing(tmp_path, extra):
    argv = ['--device', 'cpu', '--work_root', str(tmp_path / 'w'),
            '--synthetic_n', '1'] + extra
    with pytest.raises(NotImplementedError, match='item 6b'):
        irn_cli.main(argv)
    assert not (tmp_path / 'w').exists()


def test_make_sem_seg_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        irn_cli.main(['--device', 'cpu', '--work_root', str(tmp_path),
                      '--passes', 'make_sem_seg', '--synthetic_n', '1'])
