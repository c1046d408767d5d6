"""The command lines' --mesh (tests/test_cli_mesh.py, ported) on two CPU
shards (the fixture ``cpu_shards`` of tests/test_torch_mesh.py):
cli.gen_cues, cli.hsn and cli.irn's make_cam write what --mesh none
writes (M7 at 32^2: no CRF config takes the grid there, so VOC's bg max
is the batch's either way and the csv equals --mesh none's, as in the
JAX test); the training command lines (cli.train_classifier, cli.sec_dsrg
--task train, cli.irn's train_irn and --tune) train data-parallel and
track --mesh none more tightly than the JAX tests' tolerances, and exit
on a batch the shards do not divide; cli.parity forwards --mesh to every
stage."""
import argparse
import json
import os
import re

import numpy as np
import pytest
import torch

from test_torch_mesh import cpu_shards  # noqa: F401
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu_torch.cli import gen_cues, hsn as hsn_cli, irn as irn_cli
from wsss_tpu_torch.cli import common, sec_dsrg, train_classifier
from wsss_tpu_torch.io import artifacts, checkpoint

CLI_ARGS = ['--dataset', 'VOC2012', '--model', 'M7', '--synthetic_n', '5',
            '--batchsize', '4', '--img_size', '32', '--device', 'cpu']


def _in(tmp_path, monkeypatch, sub):
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.chdir(d)
    return d


def test_gen_cues_cli_mesh_matches_single(tmp_path, monkeypatch,
                                          cpu_shards):
    out = {}
    for mesh in ('none', '2'):
        _in(tmp_path, monkeypatch, mesh)
        gen_cues.main(CLI_ARGS + ['--task', 'gen', '--mesh', mesh])
        out[mesh] = artifacts.read_cue_pickle(
            'cues/VOC2012_M7/localization_cues.pickle')
    assert set(out['none']) == set(out['2']) and len(out['2']) == 10
    for k in out['none']:
        np.testing.assert_array_equal(out['2'][k], out['none'][k])


def test_hsn_cli_mesh_matches_single(tmp_path, monkeypatch, cpu_shards):
    csv = {}
    for mesh in ('none', '2'):
        d = _in(tmp_path, monkeypatch, mesh)
        hsn_cli.main(CLI_ARGS + ['--mesh', mesh])
        csv[mesh] = (d / 'eval' / 'HSN_VOC2012_M7' /
                     'hsn_iou.csv').read_text()
    assert csv['2'] == csv['none']


def test_irn_make_cam_cli_mesh(tmp_path, monkeypatch, cpu_shards):
    cams = {}
    for mesh in ('none', '2'):
        _in(tmp_path, monkeypatch, mesh)
        irn_cli.main(CLI_ARGS + ['--passes', 'make_cam', '--scales', '1.0',
                                 '--mesh', mesh])
        root = 'irn_work/IRN_VOC2012_M7/cam'
        cams[mesh] = {f: artifacts.read_cam_npy(os.path.join(root, f))
                      for f in sorted(os.listdir(root))}
    assert len(cams['2']) == 5 and cams['2'].keys() == cams['none'].keys()
    for f, d in cams['none'].items():
        np.testing.assert_array_equal(cams['2'][f]['keys'], d['keys'])
        for k in ('cam', 'high_res'):
            np.testing.assert_allclose(cams['2'][f][k], d[k], atol=1e-5)


def _ckpt(root):
    """The latest checkpoint's tensors under root, flattened."""
    state, _ = checkpoint.restore_checkpoint(str(root), map_location='cpu')
    flat = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f'{prefix}/{k}', x)
        elif isinstance(v, torch.Tensor):
            flat[prefix] = v
    walk('', state)
    return flat


def _ckpt_close(got, want, atol):
    assert got.keys() == want.keys() and want
    for k, w in want.items():
        np.testing.assert_allclose(got[k].double().numpy(),
                                   w.double().numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def _losses(text, pattern):
    return [float(m) for m in re.findall(pattern, text)]


# tests/test_cli_mesh.py's flags; M7 where the JAX tests take VGG16: the
# classifier's BatchNorm and dropout, IRNet's edge resize, and a float32
# step at 32^2 better conditioned than VGG16's
TRAIN_CLS = ['--dataset', 'VOC2012', '--model', 'M7', '--task', 'train',
             '--epochs', '1', '--synthetic_n', '4', '--batchsize', '2',
             '--img_size', '32', '--no_aug', '--no_class_wgt', '--verbose',
             '--device', 'cpu']
TRAIN_SEC = ['--dataset', 'VOC2012', '--task', 'train', '--method', 'SEC',
             '--epochs', '1', '--synthetic_n', '4', '--batchsize', '2',
             '--img_size', '72', '--val_every', '0', '--device', 'cpu']
TRAIN_IRN = ['--dataset', 'VOC2012', '--model', 'M7', '--passes',
             'make_cam,cam_to_ir_label,train_irn', '--synthetic_n', '4',
             '--batchsize', '2', '--img_size', '32', '--scales', '1.0',
             '--irn_random_trunk', '--verbose', '--device', 'cpu']


def test_train_classifier_cli_mesh_matches_single(tmp_path, monkeypatch,
                                                  capsys, cpu_shards):
    """--mesh 2 trains the --mesh none run's steps: the losses within
    1e-4 (the JAX test allows 1e-2) and the checkpoints' weights and
    BatchNorm statistics within 2e-4.  M7's float32 gradients at 32^2 are
    ill-conditioned: another order of sums moves them by ~1e-2 of their
    size by the second step (the momentum buffers) and the weights by
    ~4e-5; tests/test_torch_dp_train.py holds the step exactly in
    float64."""
    out = {}
    for mesh in ('none', '2'):
        d = _in(tmp_path, monkeypatch, mesh)
        train_classifier.main(TRAIN_CLS + ['--mesh', mesh])
        out[mesh] = (_losses(capsys.readouterr().out, r'loss ([0-9.]+)'),
                     {k: v for k, v in _ckpt(d / 'models_cnn' /
                                             'VOC2012_M7' / 'ckpt').items()
                      if k.startswith('/params/')})
    assert len(out['none'][0]) == len(out['2'][0]) == 2
    np.testing.assert_allclose(out['2'][0], out['none'][0], rtol=1e-4)
    _ckpt_close(out['2'][1], out['none'][1], atol=2e-4)


def test_sec_train_cli_mesh_matches_single(tmp_path, monkeypatch,
                                           cpu_shards):
    """SEC --task train with --mesh 2: the logged totals within 1e-5 (the
    JAX test allows 2e-3), the checkpoints within 1e-5."""
    out = {}
    for mesh in ('none', '2'):
        d = _in(tmp_path, monkeypatch, mesh)
        sec_dsrg.main(TRAIN_SEC + ['--mesh', mesh])
        log = d / 'log' / 'SEC_VOC2012_VGG16' / 'train.jsonl'
        rows = [json.loads(r) for r in log.read_text().splitlines()]
        out[mesh] = ([r['total'] for r in rows if 'total' in r],
                     _ckpt(d / 'models_wsss' / 'SEC_VOC2012_VGG16'))
    assert len(out['none'][0]) == len(out['2'][0]) == 2
    np.testing.assert_allclose(out['2'][0], out['none'][0], rtol=1e-5)
    _ckpt_close(out['2'][1], out['none'][1], atol=1e-5)


def test_irn_train_cli_mesh_matches_single(tmp_path, monkeypatch, capsys,
                                           cpu_shards):
    """make_cam -> cam_to_ir_label -> train_irn with --mesh 2: the losses
    within 1e-5 (the JAX test allows 2e-3), the IRNet checkpoint
    (variables and disp_mean) within 1e-5."""
    out = {}
    for mesh in ('none', '2'):
        d = _in(tmp_path, monkeypatch, mesh)
        irn_cli.main(TRAIN_IRN + ['--mesh', mesh])
        out[mesh] = (_losses(capsys.readouterr().out,
                             r'irn loss ([0-9.]+)'),
                     _ckpt(d / 'irn_work' / 'IRN_VOC2012_M7' /
                           'irn_ckpt'))
    assert len(out['none'][0]) == len(out['2'][0]) == 2
    assert all(np.isfinite(out['none'][0]))
    np.testing.assert_allclose(out['2'][0], out['none'][0], rtol=1e-5)
    _ckpt_close(out['2'][1], out['none'][1], atol=1e-5)


def test_irn_tune_cli_mesh(tmp_path, monkeypatch, cpu_shards):
    """--tune with --mesh 2: every train_irn step of the grid runs over
    the two shards, and the grid logs its 3 + 7 trials.  At 64^2: the
    sharded walk of make_sem_seg takes radius 5 as given, as the
    reference's does, which a 32^2 image's 8x8 grid cannot hold."""
    from wsss_tpu_torch.methods import irnet
    meshes = []
    step = irnet.IRNTrainer.train_step

    def spy(self, *a, mesh=None):
        meshes.append(None if mesh is None else mesh.shape['data'])
        return step(self, *a, mesh=mesh)
    monkeypatch.setattr(irnet.IRNTrainer, 'train_step', spy)
    monkeypatch.chdir(tmp_path)
    irn_cli.main(['--device', 'cpu', '--model', 'M7', '--img_size', '64',
                  '--synthetic_n', '2', '--batchsize', '2', '--scales',
                  '1.0', '--tune', '--mesh', '2'])
    assert meshes == [2] * 4       # train_irn 3 + 1 times, one step each
    rows = (tmp_path / 'tuning_logs' / 'IRN_VOC2012_M7.tsv').read_text(
        ).splitlines()
    assert len(rows) == 11
    assert all(np.isfinite(float(r.split('\t')[4])) for r in rows[1:])


def test_dp_train_putters(cpu_shards):
    args = argparse.Namespace(mesh='2', batchsize=3, device='cpu')
    with pytest.raises(SystemExit, match='divisible'):
        common.dp_train_putters(args)
    args.batchsize = 4
    assert common.dp_train_putters(args).shape == {'data': 2, 'model': 1}
    args.mesh = 'none'
    assert common.dp_train_putters(args) is None


def test_training_clis_exit_on_an_indivisible_batch(tmp_path, monkeypatch,
                                                    cpu_shards):
    """Before anything is written."""
    monkeypatch.chdir(tmp_path)
    for main, argv in ((train_classifier.main, []),
                       (sec_dsrg.main, ['--task', 'train']),
                       (irn_cli.main, ['--passes', 'train_irn']),
                       (irn_cli.main, ['--tune'])):
        with pytest.raises(SystemExit, match='divisible'):
            main(CLI_ARGS + argv + ['--mesh', '3'])
        assert os.listdir(tmp_path) == []


def test_parity_forwards_mesh_to_every_stage(tmp_path, monkeypatch):
    """cli.parity --mesh 2 hands --mesh 2 to each stage it runs, the
    training stages included (the stages' mains captured)."""
    from wsss_tpu_torch.cli import parity
    calls = []
    for mod in (gen_cues, hsn_cli, irn_cli, sec_dsrg, train_classifier):
        def fake(argv, name=mod.__name__.rsplit('.', 1)[-1]):
            calls.append((name, list(argv)))
            return {}
        monkeypatch.setattr(mod, 'main', fake)
    monkeypatch.chdir(tmp_path)
    parity.main(['--datasets', 'VOC2012', '--models', 'vgg16', '--device',
                 'cpu', '--mesh', '2'])
    assert {c[0] for c in calls} == {'gen_cues', 'hsn', 'irn', 'sec_dsrg',
                                     'train_classifier'}
    for name, argv in calls:
        i = argv.index('--mesh')
        assert argv[i + 1] == '2' and argv.count('--mesh') == 1, name
