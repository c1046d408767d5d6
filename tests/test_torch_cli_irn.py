"""The port's 03b command line (``wsss_tpu_torch/cli/irn.py``) against
the JAX package's.

The five inference passes make_cam, eval_cam, cam_to_ir_label,
make_sem_seg and eval_sem_seg run on the same synthetic VOC2012 split (3
images around 64^2, scales 1.0 and 0.5) with the same classifier triplet
(written by the JAX package) and the same IRNet weights: an orbax
checkpoint for the JAX CLI, a ``torch.save`` checkpoint of the bridged
module for the port's.  What is held: the cam .npy dicts (keys equal,
maps within 1e-4), the ir-label PNGs (>= 0.99 of the pixels: the CRF's
float32 sums differ in order between the packages), the sem-seg PNGs
(>= 0.999), both mIoUs within 1e-3.

train_irn: both CLIs run train_irn alone at crop 32 (3 images, batch 2,
4 epochs: 4 steps) on copies of the ir-label PNGs and the triplet that
the JAX inference run above wrote, so the CRF's float order cannot
enter and the JAX make_cam is compiled once, from the same flax initial
IRNet.  Each step's inputs are equal,
the printed losses agree within 2e-4 (printed to 4 decimals), the
checkpoint's heads within 5e-4 and its disp_mean within 1e-4.
``affinity_example`` equals the reference's calls bit for bit;
``--passes all`` and ``--tune`` run to their end on the port; the flags
equal the JAX CLI's plus ``--device``."""
import argparse
import contextlib
import functools
import io
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import perturbed_variables
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.cli import irn as jax_irn_cli
from wsss_tpu.data import augment as jax_augment
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.methods import irnet as jax_irnet
from wsss_tpu.models.irn import IRNet as JIRNet
from wsss_tpu_torch.cli import irn as irn_cli
from wsss_tpu_torch.io import checkpoint
from wsss_tpu_torch.io.flax_bridge import irnet_variables, load_flax_irnet
from wsss_tpu_torch.methods import irnet
from wsss_tpu_torch.models.irn import IRNet
from wsss_tpu_torch.ops.crf.config import IRN_TUNED

SIZE = 64
PASSES = 'make_cam,eval_cam,cam_to_ir_label,make_sem_seg,eval_sem_seg'
CAM_TOL = 1e-4
IR_FLOOR = 0.99
SEM_FLOOR = 0.999
MIOU_TOL = 1e-3
RUN = 'IRN_VOC2012_VGG16'
DISP_MEAN = np.array([0.1, -0.2], np.float32)
TRAIN_SIZE = 32
LOSS_PRINT_TOL = 2e-4
HEAD_TOL = 5e-4
DISP_MEAN_TOL = 1e-4


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


def _train_root(tmp_path_factory, name, jroot):
    """A working tree holding the JAX inference run's triplet and a copy
    of its ir-label PNGs."""
    root = tmp_path_factory.mktemp(name)
    os.symlink(jroot / 'models', root / 'models')
    shutil.copytree(jroot / 'work' / RUN / 'ir_label',
                    root / 'work' / RUN / 'ir_label')
    return root


@functools.lru_cache(maxsize=None)
def _train_init():
    """The JAX trainer's initial IRNet (vgg16, key 0) as numpy: both
    CLIs start from it, and it is the checkpoint's restore template."""
    init, _ = jax_irnet.IRNTrainer('vgg16', 21, TRAIN_SIZE).init(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, init)


def _train_argv(root):
    return ['--dataset', 'VOC2012', '--model', 'VGG16', '--img_size',
            str(SIZE), '--synthetic_n', '3', '--batchsize', '2',
            '--irn_crop_size', str(TRAIN_SIZE), '--irn_epochs', '4',
            '--verbose', '--passes', 'train_irn',
            '--model_root', str(root / 'models'),
            '--work_root', str(root / 'work')]


def _losses(text):
    return [float(ln.split()[-1]) for ln in text.splitlines()
            if ln.strip().startswith('irn loss')]


@pytest.fixture(scope='module')
def train_runs(runs, tmp_path_factory):
    """The train_irn pass of both CLIs: (JAX root, JAX step inputs, JAX
    stdout, port root, port step inputs, port stdout)."""
    jroot = _train_root(tmp_path_factory, 'jax_train', runs[0])
    proot = _train_root(tmp_path_factory, 'port_train', runs[0])
    jin, pin = [], []
    jstep = jax_irnet.IRNTrainer.jitted_step
    pstep = irnet.IRNTrainer.train_step

    def jax_recording(self):
        step = jstep(self)

        def call(variables, opt_state, *batch):
            jin.append([np.asarray(x) for x in batch])
            return step(variables, opt_state, *batch)
        return call

    def port_recording(self, *batch, **kw):
        pin.append([torch.as_tensor(x).cpu().numpy() for x in batch])
        return pstep(self, *batch, **kw)
    init = _train_init()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_irnet.IRNTrainer, 'jitted_step', jax_recording)
        mp.setattr(irnet.IRNTrainer, 'train_step', port_recording)
        mp.setattr(irnet.IRNTrainer, 'init',
                   lambda self, generator: load_flax_irnet(self.net, init))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            jax_irn_cli.main(_train_argv(jroot))
        jtext = out.getvalue()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            irn_cli.main(_train_argv(proot) + ['--device', 'cpu'])
        ptext = out.getvalue()
    print(jtext, ptext)
    return jroot, jin, jtext, proot, pin, ptext


def test_train_irn_step_inputs_equal_jax(train_runs):
    _, jin, _, _, pin, _ = train_runs
    assert len(jin) == len(pin) == 4
    for i, (want, got) in enumerate(zip(jin, pin)):
        for name, w, g in zip(('imgs', 'bg_pos', 'fg_pos', 'neg'), want,
                              got):
            print(f'step {i} {name} {w.shape}: sum {float(w.sum()):.4f}')
            np.testing.assert_array_equal(g, w, err_msg=f'{i} {name}')


def test_train_irn_losses_equal_jax(train_runs):
    _, _, jtext, _, _, ptext = train_runs
    want, got = _losses(jtext), _losses(ptext)
    print(f'losses: port {got}, JAX {want}')
    assert len(got) == len(want) == 4
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_PRINT_TOL


def test_train_irn_checkpoint_equals_jax(train_runs):
    jroot, _, _, proot, _, ptext = train_runs
    assert '[train_irn] trained; disp_mean=' in ptext
    want, _ = jax_ckpt.restore_checkpoint(
        str(jroot / 'work' / RUN / 'irn_ckpt'),
        {'variables': jax.tree_util.tree_map(jnp.asarray, _train_init()),
         'disp_mean': jnp.zeros(2)})
    got, step = checkpoint.restore_checkpoint(
        str(proot / 'work' / RUN / 'irn_ckpt'), map_location='cpu')
    assert step == 0 and sorted(got) == ['disp_mean', 'variables']
    net = IRNet('vgg16')
    net.load_state_dict(got['variables'])
    gp = irnet_variables(net)['params']
    wp = jax.tree_util.tree_map(np.asarray, want['variables']['params'])
    assert sorted(gp) == sorted(wp)
    for head in gp:
        fg = jax.tree_util.tree_leaves(gp[head])
        fw = jax.tree_util.tree_leaves(wp[head])
        d = max(float(np.abs(a - b).max()) for a, b in zip(fg, fw))
        tol = 0.0 if head == 'trunk' else HEAD_TOL
        assert d <= tol, (head, d)
    dm = np.abs(got['disp_mean'].numpy() - np.asarray(want['disp_mean']))
    print(f'disp_mean port {got["disp_mean"]}, JAX {want["disp_mean"]}')
    assert float(dm.max()) <= DISP_MEAN_TOL


class _Args:
    def __init__(self, **kw):
        self.rescale_range, self.irn_no_flip, self.crop_method = None, \
            False, None
        self.__dict__.update(kw)


@pytest.mark.parametrize('opts', [
    {}, {'crop_method': 'random', 'rescale_range': '0.7,1.3'},
    {'crop_method': 'random', 'irn_no_flip': True}])
def test_affinity_example_equals_jax(opts):
    """affinity_example against the JAX CLI's make_pack
    (wsss_tpu/cli/irn.py:run_train_irn: its calls to the JAX package's
    augment and affinity_labels in its order) on the same image, label
    and rng: images and the three label tensors bit-equal."""
    crop, n_cls = 32, 21
    pidx = irnet.PathIndex(4)
    src = np.random.default_rng(8)
    for k in range(3):
        hw = (int(src.integers(28, 48)), int(src.integers(28, 48)))
        img = src.integers(0, 256, hw + (3,)).astype(np.uint8)
        lab = src.choice([0, 3, 7, 255], hw).astype(np.int64)
        args = _Args(**opts)
        got = irn_cli.affinity_example(img, lab, args, crop, pidx, n_cls,
                                       np.random.default_rng(11 + k))
        rng = np.random.default_rng(11 + k)
        wi, wl = img, lab
        if args.rescale_range:
            wi, wl = jax_augment.random_scale(
                [wi, wl], tuple(float(v) for v in
                                args.rescale_range.split(',')), (3, 0), rng)
        if not args.irn_no_flip:
            wi, wl = jax_augment.random_lr_flip([wi, wl], rng)
        if args.crop_method == 'random':
            wi, wl = jax_augment.random_crop([wi, wl], crop, (0, 255), rng)
        else:
            wi, wl = wi[:crop, :crop], wl[:crop, :crop]
        g = crop // 4
        wl4 = jax_augment.pil_rescale(wl, 0.25, 0)[:g, :g]
        want = jax_irnet.affinity_labels(wl4, pidx, n_cls)
        np.testing.assert_array_equal(got[0], wi)
        for a, b in zip(got[1], want):
            np.testing.assert_array_equal(a, b)


def test_passes_all_runs_end_to_end(tmp_path, capsys):
    """The default --passes all on the CPU: the checkpoint, the sem-seg
    PNGs and a finite mIoU."""
    res = irn_cli.main(['--device', 'cpu', '--img_size', '32',
                        '--synthetic_n', '4', '--batchsize', '2',
                        '--scales', '1.0', '--work_root', str(tmp_path),
                        '--model_root', str(tmp_path / 'none')])
    run = tmp_path / RUN
    assert checkpoint.latest_step(str(run / 'irn_ckpt')) == 0
    assert len(os.listdir(run / 'sem_seg')) == 4
    assert sorted(res) == ['cam_miou', 'miou']
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())
    assert '[train_irn] trained' in capsys.readouterr().out


def test_tune_logs_every_trial(tmp_path, monkeypatch, capsys):
    """--tune on the port (M7: its IRNet takes the edge head's resize):
    the JAX CLI's TSV header and 3 + 7 rows in tuning_logs/ of the
    working directory, and the printed best choice is the argmax of its
    own rows."""
    monkeypatch.chdir(tmp_path)
    irn_cli.main(['--device', 'cpu', '--model', 'M7', '--img_size', '32',
                  '--synthetic_n', '2', '--batchsize', '2', '--scales',
                  '1.0', '--tune', '--work_root', 'w', '--model_root',
                  'none'])
    rows = (tmp_path / 'tuning_logs' / 'IRN_VOC2012_M7.tsv').read_text(
        ).splitlines()
    assert rows[0] == ('dataset\tmodel\tconf_fg_thres\texp_times\t'
                       'validation miou')
    trials = [r.split('\t') for r in rows[1:]]
    assert len(trials) == 10
    assert [t[2] for t in trials[:3]] == ['0.3', '0.5', '0.7']
    init_exp = IRN_TUNED[('VOC2012', 'M7')][1]
    assert {t[3] for t in trials[:3]} == {str(init_exp)}
    assert [t[3] for t in trials[3:]] == [str(e) for e in range(1, 9)
                                          if e != init_exp]
    mious = [float(t[4]) for t in trials]
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('[tune] best')]
    assert len(line) == 1
    m = re.fullmatch(r'\[tune\] best conf_fg_thres=(\S+) exp_times=(\d+) '
                     r'miou=(\S+)', line[0])
    th, exp, miou = m.groups()
    assert all(t[2] == th for t in trials[3:])
    assert [float(t[4]) for t in trials
            if (t[2], t[3]) == (th, exp)] == [max(mious)]
    assert miou == f'{max(mious):.5f}'


def test_rescale_range_needs_random_crop(tmp_path):
    with pytest.raises(SystemExit, match='--crop_method random'):
        irn_cli.main(['--device', 'cpu', '--work_root', str(tmp_path),
                      '--passes', 'train_irn', '--synthetic_n', '2',
                      '--img_size', '32', '--rescale_range', '0.5,1.5'])


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser that ``main`` builds, caught at parse_args."""
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed
    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, 'parse_args', grab)
        with pytest.raises(_Parsed):
            main([])
    return {o: a for a in seen[0]._actions for o in a.option_strings}


def test_flags_equal_jax_plus_device(monkeypatch):
    got = _parser_of(irn_cli.main, monkeypatch)
    want = _parser_of(jax_irn_cli.main, monkeypatch)
    assert sorted(set(got) - {'--device'}) == sorted(want)
    for flag, a in want.items():
        if flag in ('-h', '--help'):
            continue
        b = got[flag]
        assert (b.default, b.type, b.nargs, b.const, b.choices) == \
            (a.default, a.type, a.nargs, a.const, a.choices), flag


def test_make_sem_seg_needs_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        irn_cli.main(['--device', 'cpu', '--work_root', str(tmp_path),
                      '--passes', 'make_sem_seg', '--synthetic_n', '1'])
