"""The whole chain on the port: the published tables
(``wsss_tpu_torch/eval/baseline.py``) against the JAX package's, the
in-memory chain of ``tests/test_full_pipeline.py`` on the port, and the
port's parity harness (``wsss_tpu_torch/cli/parity.py``) on the fake VOC
devkit of ``tests/test_parity_harness.py`` against the JAX harness.

Harness runs: the JAX harness and the port's with ``--skip_train`` from
the same JAX-exported classifier triplets (fg and bg, thresholds away
from every score) in each working directory, and the port's with its
own 01 training.  What is held: the report's rows equal the JAX
harness's in every column but miou / delta / ok; from the same triplets
the Grad-CAM and HistoSegNet mIoUs within 1e-3; both harnesses exit
through SystemExit alike (a row outside the budget); ``--numerics``
switches in force during the stages and restored after ``main``."""
import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_parity_harness import _fake_voc_devkit
from test_torch_models import perturbed_variables
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.cli import parity as jax_parity
from wsss_tpu.eval import baseline as jax_baseline
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu_torch.cli import parity
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.data.pipeline import SyntheticWSSS
from wsss_tpu_torch.eval import baseline, metrics
from wsss_tpu_torch.io import artifacts
from wsss_tpu_torch.methods import gradcam_cues as gc
from wsss_tpu_torch.methods import hsn, irnet
from wsss_tpu_torch.methods.gradcam_cues import (_ClassifierHandle,
                                                 _normalizer)
from wsss_tpu_torch.models.backbones import build_classifier
from wsss_tpu_torch.models.irn import edge_displacement_inference
from wsss_tpu_torch.ops.crf import meanfield
from wsss_tpu_torch.ops.crf.config import CRFConfig
from wsss_tpu_torch.ops.filters import resize_nearest
from wsss_tpu_torch.train.classifier import ClassifierTrainer
from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer

MIOU_TOL = 1e-3
HARNESS = ['--datasets', 'VOC2012', '--models', 'vgg16', '--img_size',
           '32', '--batchsize', '3', '--clf_epochs', '1', '--scales', '1.0',
           '--skip_methods', 'sec,dsrg,irnet']
SAME = ('dataset', 'model', 'method', 'split', 'published')
# the port's run with its own 01 training checks rows and exit only, so
# it runs at the smallest input VGG16 takes (four pools to 1x1)
TRAIN_SIZE = ['--img_size', '16']


@pytest.mark.parametrize('dataset', jax_parity.ALL_DATASETS)
def test_baseline_tables_equal_jax(dataset):
    """The port's copy of the published tables, entry for entry."""
    assert baseline.METHODS == jax_baseline.METHODS
    assert baseline._TABLE == jax_baseline._TABLE
    assert baseline.all_rows() == jax_baseline.all_rows()
    assert len(baseline.all_rows()) == 70
    assert baseline.alt_model(dataset) == jax_baseline.alt_model(dataset)
    splits = baseline.eval_splits(dataset)
    assert splits == jax_baseline.eval_splits(dataset)
    for split in splits + ('train', 'nosuch'):
        for model in ('VGG16', 'M7', 'X1.7', 'M1'):
            for method in baseline.METHODS + ('nosuch',):
                assert (baseline.published_miou(dataset, split, model,
                                                method)
                        == jax_baseline.published_miou(dataset, split,
                                                       model, method))


def _thresholds(n):
    return np.where(np.arange(n) % 2 == 0, 0.0, 1.01).astype(np.float32)


def _export_triplets(models, present):
    """VOC VGG16 fg and bg triplets written by the JAX package.  The fg
    head's bias is lowered by 5 for the classes absent from the devkit's
    ground truth, so that only present classes pass HistoSegNet's CAM
    gate and the CRF weighs them against the bg channel (with every
    class passing, random weights label no pixel right; with none, every
    pixel is bg)."""
    for seed, suffix in enumerate(('', 'bg')):
        sid = f'VOC2012_VGG16{suffix}'
        _, variables = perturbed_variables('VGG16', 20, 32, seed)
        params = variables['params']
        if not suffix:
            params['head']['bias'] = params['head']['bias'] + np.array(
                [0.0 if c + 1 in present else -5.0 for c in range(20)],
                np.float32)
        jax_ckpt.export_triplet(str(models / sid), sid, {'model': 'VGG16'},
                                params, thresholds=_thresholds(20))


def _report(wd):
    with open(wd / 'eval' / 'parity_report.csv', newline='') as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def harness_runs(tmp_path_factory):
    """{run: (report rows, exited through SystemExit)} of the JAX
    harness and the port's with --skip_train on the same triplets, and
    of the port's with its own training, on one fake devkit."""
    root = tmp_path_factory.mktemp('devkit')
    names = _fake_voc_devkit(str(root))
    gt_dir = root / 'VOCdevkit' / 'VOC_trainaug_val' / 'VOC2012' / \
        'SegmentationClassAug'
    present = set().union(*(np.unique(np.asarray(Image.open(
        gt_dir / f'{n}.png'))).tolist() for n in names))
    runs = {}
    for name, main, extra in (
            ('jax_skip', jax_parity.main, ['--skip_train']),
            ('port_skip', parity.main, ['--skip_train', '--device', 'cpu']),
            ('port_train', parity.main, ['--device', 'cpu'] + TRAIN_SIZE)):
        wd = tmp_path_factory.mktemp(name)
        if name.endswith('skip'):
            _export_triplets(wd / 'models_cnn', present)
        exited = False
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(wd)
            try:
                main(['--data_root', str(root)] + HARNESS + extra)
            except SystemExit:
                exited = True
        runs[name] = (_report(wd), exited)
    return runs


def test_parity_harness_on_devkit(harness_runs):
    """tests/test_parity_harness.py::test_parity_harness_on_devkit on the
    port: classifier -> cues -> HSN on a devkit tree, diffs outside the
    budget exit through SystemExit, the report's rows are the JAX
    harness's but for the measured columns."""
    rows, exited = harness_runs['port_train']
    assert exited
    assert list(rows[0]) == ['dataset', 'model', 'method', 'split', 'miou',
                             'published', 'delta', 'ok']
    assert {'Grad-CAM', 'HistoSegNet'} <= {r['method'] for r in rows}
    assert all(r['delta'] not in ('', 'None') for r in rows)
    want, _ = harness_runs['jax_skip']
    assert [[r[k] for k in SAME] for r in rows] == \
        [[r[k] for k in SAME] for r in want]


def test_skip_train_mious_equal_jax(harness_runs):
    """From the same JAX-exported triplets: the rows equal the JAX
    harness's but for the measured columns, the Grad-CAM and HistoSegNet
    mIoUs within 1e-3."""
    (got, g_exit), (want, w_exit) = (harness_runs['port_skip'],
                                     harness_runs['jax_skip'])
    assert g_exit == w_exit
    assert [[r[k] for k in SAME] for r in got] == \
        [[r[k] for k in SAME] for r in want]
    assert {r['method'] for r in got} == {'Grad-CAM', 'HistoSegNet'}
    for g, w in zip(got, want):
        print(f'{g["method"]} {g["split"]}: port {g["miou"]}, JAX '
              f'{w["miou"]}')
        assert float(w['miou']) > 0.0
        assert abs(float(g['miou']) - float(w['miou'])) <= MIOU_TOL


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_numerics_switches_restored(mode, monkeypatch, tmp_path):
    """--numerics sets the environment and the meanfield flag for the
    stages and restores both when main returns."""
    monkeypatch.setenv('WSSS_TPU_BF16_INFER', 'before')
    monkeypatch.delenv('WSSS_TPU_NO_BF16_INFER', raising=False)
    monkeypatch.setattr(meanfield, '_CRF_STATE_BF16', 'before')
    monkeypatch.chdir(tmp_path)
    seen = []

    def combo(a, dataset, model):
        seen.append((os.environ.get('WSSS_TPU_BF16_INFER'),
                     os.environ.get('WSSS_TPU_NO_BF16_INFER'),
                     meanfield._CRF_STATE_BF16, a.device))
        return []
    monkeypatch.setattr(parity, 'run_combo', combo)
    assert parity.main(['--datasets', 'VOC2012', '--models', 'vgg16',
                        '--numerics', mode, '--device', 'cpu']) == []
    want = ('1', None, True) if mode == 'bf16' else (None, None, False)
    assert seen == [want + ('cpu',)]
    assert os.environ['WSSS_TPU_BF16_INFER'] == 'before'
    assert 'WSSS_TPU_NO_BF16_INFER' not in os.environ
    assert meanfield._CRF_STATE_BF16 == 'before'


SIZE = 48
CFG = CRFConfig(1.0, 2, 3.0, 30, 4, iterations=2)


def test_full_chain():
    """tests/test_full_pipeline.py::test_full_chain on the port, in memory
    on the CPU: train classifier -> calibrate -> cues -> SEC training
    steps -> HSN -> IRNet (cam -> ir_label -> train step -> random walk)
    -> mIoU, with the data contracts between stages."""
    dev = 'cpu'
    spec = registry.get('VOC2012')
    ds = SyntheticWSSS('VOC2012', size=SIZE, n_images=4)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)

    # --- stage 1: classifier training + threshold calibration ----------
    model = build_classifier('M7', spec.n_fg_classes)
    trainer = ClassifierTrainer(model, lr=0.05, schedule='const',
                                device=dev)
    trainer.init(torch.Generator().manual_seed(0))
    norm = _normalizer(spec.norm_cues, dev)
    for i, b in enumerate(ds.batches(4)):
        trainer.train_step(norm(f32(b.images)), f32(b.tags),
                           torch.Generator().manual_seed(i))
    b = next(ds.batches(4))
    scores = trainer.eval_scores(norm(f32(b.images)))
    th = metrics.optimal_thresholds(b.tags, scores).numpy()
    assert th.shape == (spec.n_fg_classes,)

    # --- stage 2: cue generation with the trained model ----------------
    fg = _ClassifierHandle(model, th, SIZE, device=dev)
    bg = _ClassifierHandle.random('M7', spec.n_fg_classes, SIZE, seed=9,
                                  device=dev)
    gen = gc.VOCDeepGlobeCueGenerator(spec, fg, bg, thresh=0.2, device=dev)
    cue_dict = gen.run(ds.batches(4))
    assert '0_cues' in cue_dict and cue_dict['0_cues'].shape[0] == 3

    # --- stage 3a: SEC training from those cues ------------------------
    n_seg = spec.n_seg_classes
    sec = SECDSRGTrainer('SEC', n_seg, base_lr=1e-3, crf_cfg=CFG,
                         device=dev)
    sec.init(torch.Generator().manual_seed(1))
    grid = (SIZE - 1) // 8 + 1
    cues = torch.stack([
        resize_nearest(f32(artifacts.unpack_cues(cue_dict, i,
                                                 (41, 41, n_seg))),
                       (grid, grid)) for i in range(4)])
    labels = np.zeros((4, n_seg), np.float32)
    labels[:, 0] = 1
    for i in range(4):
        labels[i][cue_dict[f'{i}_labels']] = 1
    losses = [float(sec.train_step(
        norm(f32(b.images)), f32(b.images), cues, labels,
        torch.Generator().manual_seed(i))['total']) for i in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    # --- stage 3c: HSN segmentation with the trained classifier --------
    seg = hsn.HSNSegmenter(spec, fg, bg, cfg=CFG, device=dev)
    pred = seg.segment_batch(b.images)
    assert pred.shape == (4, SIZE, SIZE)
    conf = metrics.confusion_matrix(pred, torch.as_tensor(b.gt), n_seg)
    _, miou = metrics.iou_from_confusion(conf)
    assert 0.0 <= float(miou) <= 1.0

    # --- stage 3b: IRNet cam -> ir_label -> train -> random walk -------
    ci = irnet.CAMInference(fg, spec, 'M7', scales=(1.0,), device=dev)
    d = ci.make_cam(b.images[0], b.tags[0])
    assert d['keys'].size
    ir = irnet.cam_to_ir_label(b.images[0], d, 'VOC2012',
                               conf_fg_thres=0.5, cfg=CFG, device=dev)
    assert ir.shape == (SIZE, SIZE)
    tr = irnet.IRNTrainer('m7', crop_size=SIZE, radius=3, max_step=4,
                          device=dev)
    tr.init(torch.Generator().manual_seed(2))
    lab4 = ir[::4, ::4].astype(np.int64)
    bgp, fgp, ngp = (x[None] for x in
                     irnet.affinity_labels(lab4, tr.path_index, n_seg))
    x = norm(f32(b.images[:1]))
    parts = tr.train_step(x, bgp, fgp, ngp)
    assert np.isfinite(float(parts['total']))
    edge, disp = edge_displacement_inference(tr.net.eval(), x, np.zeros(2))
    sem = irnet.make_sem_seg(edge, d, 'VOC2012', (SIZE, SIZE), exp_times=1,
                             device=dev)
    assert sem.shape == (SIZE, SIZE)
