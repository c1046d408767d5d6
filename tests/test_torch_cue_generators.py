"""Cue generation end to end (the 02_cues stage) in the port against the
JAX package: the generators and ``cli/gen_cues.py`` on SyntheticWSSS at
64^2, 8 images in batches of 4, with the same flax weights on both sides.

Thresholds: 0.0 for half the classes and 1.01 for the rest, so that no
score (a sigmoid in (0, 1)) lies within 1e-2 of its threshold and the pass
mask takes both branches; random weights put every score near 0.5, where
a 0.5 threshold would flip on float noise.

What is held: '{i}_labels' equal; '{i}_cues' equal, or else the dense
one-hot volumes agree on >= 0.999 of each image's 41x41 seed pixels (the
thresholds compare float CAMs, and the two packages' f32 convolutions
differ in the last bits).  The tests print how many images were equal
and the lowest agreement.  cues_iou.csv's mIoU within 1e-6, its text and its .xlsx sibling's table
equal."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_models import perturbed_variables
from wsss_tpu.cli import gen_cues as jax_cli
from wsss_tpu.data import registry as jax_registry
from wsss_tpu.data.pipeline import SyntheticWSSS as JaxSynthetic
from wsss_tpu.eval import xlsx as jax_xlsx
from wsss_tpu.io import artifacts as jax_artifacts
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.methods import gradcam_cues as jax_gc
from wsss_tpu_torch.cli import gen_cues as cli
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.data.pipeline import SyntheticWSSS
from wsss_tpu_torch.eval import xlsx
from wsss_tpu_torch.io import artifacts
from wsss_tpu_torch.methods import gradcam_cues as gc

SIZE, N_IMAGES, BATCH = 64, 8, 4


def _thresholds(n):
    return np.where(np.arange(n) % 2 == 0, 0.0, 1.01).astype(np.float32)


def _handles(tag, n, seed):
    """(JAX handle, port handle on the CPU) with perturbed flax weights."""
    model, variables = perturbed_variables(tag, n, SIZE, seed)
    th = _thresholds(n)
    jh = jax_gc._ClassifierHandle(
        model, jax.tree_util.tree_map(jnp.asarray, variables), th, SIZE)
    return jh, gc._ClassifierHandle.from_flax(tag, variables, th, SIZE,
                                              device='cpu')


def compare_cues(got, want, n_classes, what):
    """Hold two pickle dicts to each other; returns the lowest per-image
    agreement of the dense volumes."""
    assert set(got) == set(want), what
    idx = sorted(int(k.split('_')[0]) for k in want if k.endswith('_cues'))
    n_equal, worst = 0, 1.0
    for i in idx:
        np.testing.assert_array_equal(got[f'{i}_labels'],
                                      want[f'{i}_labels'], err_msg=what)
        assert got[f'{i}_labels'].dtype == want[f'{i}_labels'].dtype
        if np.array_equal(got[f'{i}_cues'], want[f'{i}_cues']):
            n_equal += 1
            continue
        shape = (41, 41, n_classes)
        a = artifacts.unpack_cues(got, i, shape)
        b = artifacts.unpack_cues(want, i, shape)
        worst = min(worst, float(np.all(a == b, axis=-1).mean()))
    print(f'{what}: {n_equal} of {len(idx)} images with equal cues; '
          f'lowest agreement of the rest {worst:.6f}')
    assert worst >= 0.999, what
    return worst


def test_synthetic_dataset_equals_jax():
    for name in ('VOC2012', 'ADP-morph', 'DeepGlobe'):
        ours = SyntheticWSSS(name, size=SIZE, n_images=5, seed=3)
        ref = JaxSynthetic(name, size=SIZE, n_images=5, seed=3)
        for b, r in zip(ours.batches(2), ref.batches(2)):
            np.testing.assert_array_equal(b.indices, r.indices)
            assert b.names == r.names
            for k in ('images', 'tags', 'gt'):
                np.testing.assert_array_equal(getattr(b, k), getattr(r, k))


@pytest.mark.parametrize('dataset', ['VOC2012', 'DeepGlobe'])
def test_voc_deepglobe_generator_equals_jax(dataset):
    spec = registry.get(dataset)
    n = spec.n_fg_classes
    j_fg, t_fg = _handles('M7', n, seed=0)
    j_bg, t_bg = (_handles('M7', n, seed=1) if spec.uses_bg_net
                  else (None, None))
    j_gen = jax_gc.VOCDeepGlobeCueGenerator(jax_registry.get(dataset),
                                            j_fg, j_bg, thresh=0.2)
    t_gen = gc.VOCDeepGlobeCueGenerator(spec, t_fg, t_bg, thresh=0.2,
                                        device='cpu')
    ds = SyntheticWSSS(dataset, size=SIZE, n_images=N_IMAGES)
    want = j_gen.run(JaxSynthetic(dataset, size=SIZE,
                                  n_images=N_IMAGES).batches(BATCH))
    got = t_gen.run(ds.batches(BATCH))
    compare_cues(got, want, spec.n_seg_classes, dataset)
    b = next(ds.batches(BATCH))
    oh, is_pass = t_gen.generate_batch(b.images, b.tags)
    assert oh.shape == (BATCH, 41, 41, spec.n_seg_classes)
    assert not np.any(is_pass.numpy() & (b.tags < 0.5))
    iou, miou = gc.eval_cues_miou(got, ds.batches(BATCH, with_gt=True),
                                  spec.n_seg_classes, dataset=dataset)
    iou_j, miou_j = jax_gc.eval_cues_miou(
        want, ds.batches(BATCH, with_gt=True), spec.n_seg_classes,
        dataset=dataset)
    np.testing.assert_allclose(iou, iou_j, atol=1e-6)
    assert abs(miou - miou_j) <= 1e-6
    with pytest.raises(NotImplementedError, match='queue 1 item 8'):
        t_gen.run(ds.batches(BATCH), mesh=object())


@pytest.mark.parametrize('family,n', [('M7', 31), ('X1.7', 51)])
def test_adp_generator_equals_jax(family, n):
    jh, th = _handles(family, n, seed=3)
    j_gen = jax_gc.ADPCueGenerator(jh, family, thresh=0.2)
    t_gen = gc.ADPCueGenerator(th, family, thresh=0.2, device='cpu')
    want_m, want_f = j_gen.run(JaxSynthetic(
        'ADP-morph', size=SIZE, n_images=N_IMAGES).batches(BATCH))
    ds = SyntheticWSSS('ADP-morph', size=SIZE, n_images=N_IMAGES)
    got_m, got_f = t_gen.run(ds.batches(BATCH))
    compare_cues(got_m, want_m, 29, f'ADP {family} morph')
    compare_cues(got_f, want_f, 5, f'ADP {family} func')
    for i in range(N_IMAGES):
        assert 1 in got_f[f'{i}_labels']            # 'Other' always
    iou, miou = gc.eval_cues_miou(got_m, ds.batches(BATCH, with_gt=True),
                                  29, dataset='ADP-morph', size=SIZE)
    iou_j, miou_j = jax_gc.eval_cues_miou(
        want_m, ds.batches(BATCH, with_gt=True), 29, dataset='ADP-morph',
        size=SIZE)
    np.testing.assert_allclose(iou, iou_j, atol=1e-6, equal_nan=True)
    assert miou == pytest.approx(miou_j, abs=1e-6, nan_ok=True)


CLI = {'VOC2012': ('M7', 20, ('', 'bg'), ('--saveimg',)),
       'ADP-morph': ('X1.7', 51, ('',), ())}


def _argv(dataset, task, root, models):
    tag, _, _, extra = CLI[dataset]
    return ['--dataset', dataset, '--model', tag, '--task', task,
            '--batchsize', str(BATCH), '--synthetic_n', str(N_IMAGES),
            '--img_size', str(SIZE), '--split', 'train',
            '--model_root', str(models), '--cues_root', str(root / 'cues'),
            '--eval_root', str(root / 'eval'),
            '--out_root', str(root / 'out')] + list(extra)


@pytest.fixture(scope='module')
def reference_cli(tmp_path_factory):
    """dataset -> (models dir, output root, result) of the reference's
    ``main`` with --task eval, run once per dataset on triplets the
    reference wrote (its --task gen writes the same pickle before the
    eval branch)."""
    runs = {}

    def run(dataset):
        if dataset not in runs:
            tag, n, suffixes, _ = CLI[dataset]
            base = tmp_path_factory.mktemp(dataset)
            for seed, suffix in enumerate(suffixes):
                sid = f'{dataset}_{tag}{suffix}'
                _, variables = perturbed_variables(tag, n, SIZE, seed)
                jax_ckpt.export_triplet(
                    str(base / 'models' / sid), sid, {'model': tag},
                    variables['params'], thresholds=_thresholds(n))
            res = jax_cli.main(_argv(dataset, 'eval', base / 'jax',
                                     base / 'models'))
            runs[dataset] = (base / 'models', base / 'jax', res)
        return runs[dataset]
    return run


def _cross_read(jax_path, port_path):
    """Each side's pickle reads back through the other's reader."""
    want = artifacts.read_cue_pickle(str(jax_path))
    got = jax_artifacts.read_cue_pickle(str(port_path))
    assert set(want) == set(got)
    return got, want


def _xlsx_equal(root, ref, csv):
    """The csv's .xlsx sibling equals the JAX CLI's as a table, each read
    by the other package's reader."""
    got = root / csv.replace('.csv', '.xlsx')
    want = ref / csv.replace('.csv', '.xlsx')
    table = jax_xlsx.read_table_xlsx(str(got))
    assert table == xlsx.read_table_xlsx(str(want))
    assert table['Class'][-1] == 'Mean' and len(table) == 2


@pytest.mark.parametrize('task', ['gen', 'eval'])
def test_cli_voc_equals_jax(tmp_path, reference_cli, task):
    models, ref, ref_result = reference_cli('VOC2012')
    result = cli.main(_argv('VOC2012', task, tmp_path, models)
                      + ['--device', 'cpu'])
    rel = os.path.join('cues', 'VOC2012_M7', 'localization_cues.pickle')
    got, want = _cross_read(ref / rel, tmp_path / rel)
    compare_cues(got, want, 21, f'CLI VOC2012 {task}')
    if task == 'gen':
        assert result is None and not (tmp_path / 'eval').exists()
        return
    assert abs(result['cue_miou'] - ref_result['cue_miou']) <= 1e-6
    csv = os.path.join('eval', 'VOC2012_M7', 'cues_iou.csv')
    assert (tmp_path / csv).read_text() == (ref / csv).read_text()
    _xlsx_equal(tmp_path, ref, csv)
    pngs = sorted(os.listdir(ref / 'out' / 'VOC2012_M7'))
    assert len(pngs) == 2 * N_IMAGES
    assert sorted(os.listdir(tmp_path / 'out' / 'VOC2012_M7')) == pngs
    if all(np.array_equal(got[k], want[k]) for k in want):
        # equal cues: the debug PNGs are equal bytes
        for name in pngs:
            assert ((tmp_path / 'out' / 'VOC2012_M7' / name).read_bytes()
                    == (ref / 'out' / 'VOC2012_M7' / name).read_bytes()), \
                name


@pytest.mark.parametrize('task', ['gen', 'eval'])
def test_cli_adp_equals_jax(tmp_path, reference_cli, task):
    models, ref, ref_result = reference_cli('ADP-morph')
    result = cli.main(_argv('ADP-morph', task, tmp_path, models)
                      + ['--device', 'cpu'])
    for htt, n in (('morph', 29), ('func', 5)):
        rel = os.path.join('cues', 'ADP-morph_X1.7', htt,
                           'localization_cues.pickle')
        got, want = _cross_read(ref / rel, tmp_path / rel)
        compare_cues(got, want, n, f'CLI ADP {htt} {task}')
        if task == 'gen':
            continue
        assert result[f'cue_miou_{htt}'] == pytest.approx(
            ref_result[f'cue_miou_{htt}'], abs=1e-6, nan_ok=True)
        csv = os.path.join('eval', 'ADP-morph_X1.7', htt, 'cues_iou.csv')
        assert (tmp_path / csv).read_text() == (ref / csv).read_text()
        _xlsx_equal(tmp_path, ref, csv)
    assert bool(result) == (task == 'eval')   # {} after gen, as the reference


def test_cli_thresh_naming_and_val_pickle(tmp_path):
    """The _0.x session-name quirk and the _val pickle of eval splits
    (02_cues/demo.py:70-71, 320-321); --mesh takes only 'none'."""
    argv = ['--dataset', 'DeepGlobe', '--model', 'M7', '--thresh', '0.3',
            '--split', 'val', '--batchsize', '4', '--synthetic_n', '4',
            '--img_size', '32', '--model_root', str(tmp_path / 'none'),
            '--cues_root', str(tmp_path / 'cues'), '--device', 'cpu']
    cli.main(argv)
    path = tmp_path / 'cues' / 'DeepGlobe_M7_0.3' / \
        'localization_cues_val.pickle'
    with open(path, 'rb') as f:
        assert len(pickle.load(f)) == 8
    with pytest.raises(SystemExit):
        cli.main(argv + ['--mesh', 'auto'])
