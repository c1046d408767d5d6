"""The command lines' --mesh (tests/test_cli_mesh.py's inference cases,
ported): cli.gen_cues, cli.hsn and cli.irn's make_cam with --mesh 2 on
two CPU shards (the fixture ``cpu_shards`` of tests/test_torch_mesh.py)
write what --mesh none writes, and the training command lines refuse a
mesh before writing anything (ROADMAP item 8b).  M7 at 32^2: no CRF
config takes the grid there, so VOC's bg max is the batch's either way
and the csv equals --mesh none's, as in the JAX test."""
import os

import numpy as np
import pytest

from test_torch_mesh import cpu_shards  # noqa: F401
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu_torch.cli import gen_cues, hsn as hsn_cli, irn as irn_cli
from wsss_tpu_torch.cli import sec_dsrg, train_classifier
from wsss_tpu_torch.io import artifacts

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


@pytest.mark.parametrize('main,argv', [
    (train_classifier.main, []),
    (sec_dsrg.main, ['--task', 'train']),
    (irn_cli.main, ['--passes', 'make_cam,train_irn']),
    (irn_cli.main, ['--tune'])])
def test_training_clis_refuse_a_mesh(tmp_path, monkeypatch, cpu_shards,
                                     main, argv):
    """Data-parallel training waits for item 8b: refused before anything
    is written."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match='item 8b'):
        main(CLI_ARGS + argv + ['--mesh', '2'])
    assert os.listdir(tmp_path) == []
