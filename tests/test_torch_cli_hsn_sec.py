"""The port's HistoSegNet and SEC/DSRG-predict command lines, and the
results aggregator and run renamer, against the JAX package's CLIs on the
same synthetic splits and the same weights (Pallas in interpret mode):

  * cli/hsn VOC2012, VGG16 fg + bg at 104^2 (the smallest size whose CRF
    takes the bilateral grid), 2 images, from triplets the JAX package
    wrote;
  * cli/hsn ADP-morph, X1.7 at 48^2, 4 images in batches of 2, with
    learned-CRF .npy files of a small window (1.5, 3, 4, 13, 10) x 2;
  * cli/sec_dsrg --task predict, SEC on VOC2012 at network size 65,
    2 native-size images: an orbax checkpoint for the JAX package, a port
    checkpoint of the same params carried across by the flax bridge.

What is held: the csv row names equal; labels read back from the
--saveimg PNGs through the palette agree on >= 0.99 of the pixels (the
reference rounds its grid and filter input/output to bf16, the f32 port
does not, so pixels near a class tie may flip), and with the port's CRF
in its reference-rounding mode (VOC) the csv text is equal; per-class IoU
within IOU_TOL of the reference's.  The port's csv, xlsx and PNGs read
back through the JAX package's readers."""
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_deeplab import bridged_deeplab
from test_torch_models import perturbed_variables
from wsss_tpu.cli import extract_eval as jax_extract_cli
from wsss_tpu.cli import hsn as jax_hsn_cli
from wsss_tpu.cli import rename_runs as jax_rename_cli
from wsss_tpu.cli import sec_dsrg as jax_sec_cli
from wsss_tpu.eval import xlsx as jax_xlsx
from wsss_tpu.io import checkpoint as jax_ckpt
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu.train.sec_dsrg import SECDSRGTrainer
from wsss_tpu_torch.cli import extract_eval as extract_cli
from wsss_tpu_torch.cli import hsn as hsn_cli
from wsss_tpu_torch.cli import rename_runs as rename_cli
from wsss_tpu_torch.cli import sec_dsrg as sec_cli
from wsss_tpu_torch.cli import train_classifier as train_cli
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.io import checkpoint
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.ops.crf import meanfield as mf
from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor

# A flipped pixel moves the IoU of the two classes it leaves and joins by
# about 1/union; 1% of a small synthetic split's pixels can move a small
# class's IoU by a few hundredths.
IOU_TOL = 0.05
LABEL_FLOOR = 0.99
FC8_GAIN = 400.0


def _thresholds(n):
    return np.where(np.arange(n) % 2 == 0, 0.0, 1.01).astype(np.float32)


def _common(dataset, model, size, n, batch, models, root):
    return ['--dataset', dataset, '--model', model, '--img_size', str(size),
            '--synthetic_n', str(n), '--batchsize', str(batch),
            '--model_root', str(models), '--eval_root', str(root / 'eval'),
            '--out_root', str(root / 'out'), '--saveimg']


def _export(models, dataset, tag, n, size, suffixes):
    for seed, suffix in enumerate(suffixes):
        sid = f'{dataset}_{tag}{suffix}'
        _, variables = perturbed_variables(tag, n, size, seed)
        jax_ckpt.export_triplet(str(models / sid), sid, {'model': tag},
                                variables['params'],
                                thresholds=_thresholds(n))


def _pcc(root):
    """Learned-config .npy files of a small window, read by
    load_learned_config in both packages."""
    paths = []
    for htt, row in (('morph', [1.5, 3, 4, 13, 10, 2]),
                     ('func', [1.5, 5, 4, 10, 10, 2])):
        paths += [f'--{htt}_pcc', str(root / f'{htt}.npy')]
        np.save(paths[-1], np.array([row], np.float64))
    return paths


RUNS = {
    'voc': lambda root: (
        _common('VOC2012', 'VGG16', 104, 2, 2, root / 'models', root)
        + ['--split', 'val']),
    'adp': lambda root: (
        _common('ADP-morph', 'X1.7', 48, 4, 2, root / 'models', root)
        + _pcc(root)),
    'sec': lambda root: (
        _common('VOC2012', 'VGG16', 65, 2, 1, root / 'models', root)
        + ['--task', 'predict', '--method', 'SEC',
           '--wsss_model_root', str(root / 'wsss')]),
}


@pytest.fixture(scope='module')
def reference(tmp_path_factory):
    """run -> (root of the JAX CLI's run, its result[, SEC's numpy
    params]), each run once.  The models each run reads: triplets the JAX
    package wrote; for SEC an orbax checkpoint of the JAX trainer's state,
    whose params the port's run gets as a torch.save checkpoint."""
    cache = {}

    def run(name):
        if name in cache:
            return cache[name]
        root = tmp_path_factory.mktemp(name)
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)
        try:
            if name == 'voc':
                _export(root / 'models', 'VOC2012', 'VGG16', 20, 104,
                        ('', 'bg'))
                res = jax_hsn_cli.main(RUNS[name](root))
            elif name == 'adp':
                _export(root / 'models', 'ADP-morph', 'X1.7', 51, 48, ('',))
                res = jax_hsn_cli.main(RUNS[name](root))
            else:
                _, np_params, _ = bridged_deeplab('SEC', 21, 65, seed=4)
                # random weights label every pixel alike; a steeper last
                # layer lets the features' spatial variation pick labels
                fc8 = np_params['head']['fc8']
                fc8['kernel'] = fc8['kernel'] * FC8_GAIN
                trainer = SECDSRGTrainer('SEC', 'VOC2012', 21)
                _, opt_state = trainer.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 65, 65, 3)))
                params = jax.tree_util.tree_map(jnp.asarray, np_params)
                jax_ckpt.save_checkpoint(
                    str(root / 'wsss' / 'SEC_VOC2012_VGG16'), 40,
                    {'params': params, 'opt_state': opt_state})
                res = jax_sec_cli.main(RUNS[name](root))
        finally:
            mp.undo()
        cache[name] = (root, res) + ((np_params,) if name == 'sec' else ())
        return cache[name]
    return run


def _port_root(tmp_path, ref_root):
    """The port's run root, reading the same model directory."""
    os.symlink(ref_root / 'models', tmp_path / 'models')
    return tmp_path


def _labels_from_pngs(out_dir, palette):
    """name -> labels, colour PNGs read back through the palette."""
    lut = {tuple(c): i for i, c in enumerate(np.asarray(palette))}
    out = {}
    for f in sorted(os.listdir(out_dir)):
        if f.endswith('.png') and not f.endswith('_overlay.png'):
            rgb = np.asarray(Image.open(os.path.join(out_dir, f)))
            out[f] = np.vectorize(lambda *c: lut[c])(
                rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return out


def _hold(got_root, want_root, rel_csv, rel_out, palette, floor=LABEL_FLOOR):
    """csv rows, IoU, xlsx and labels of one run against the reference's;
    returns the label agreement."""
    def rows(root):
        with open(root / 'eval' / rel_csv) as f:
            return [line.strip().split(',') for line in f]
    got, want = rows(got_root), rows(want_root)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert got[0] == want[0] == ['class', 'iou']
    np.testing.assert_allclose([float(r[1]) for r in got[1:]],
                               [float(r[1]) for r in want[1:]], atol=IOU_TOL)
    # the xlsx sibling, through the JAX package's reader
    table = jax_xlsx.read_table_xlsx(
        str(got_root / 'eval' / rel_csv.replace('.csv', '.xlsx')))
    assert table['Class'][:-1] == [r[0] for r in got[1:-1]]
    assert table['Class'][-1] == 'Mean'
    a = _labels_from_pngs(got_root / 'out' / rel_out, palette)
    b = _labels_from_pngs(want_root / 'out' / rel_out, palette)
    assert sorted(a) == sorted(b) and a
    agree = np.mean([(a[k] == b[k]).mean() for k in b])
    n_labels = len(np.unique(np.concatenate([v.ravel() for v in b.values()])))
    print(f'{rel_csv}: label agreement {agree:.6f} over {len(b)} images '
          f'({n_labels} labels in the reference)')
    assert agree >= floor, agree
    return agree


@pytest.mark.parametrize('ref_round', [False, True])
def test_hsn_voc_equals_jax(tmp_path, reference, monkeypatch, ref_round):
    ref_root, ref_res = reference('voc')[:2]
    if ref_round:
        monkeypatch.setattr(hsn, 'mean_field',
                            functools.partial(mf.mean_field, ref_round=True))
    root = _port_root(tmp_path, ref_root)
    res = hsn_cli.main(RUNS['voc'](root) + ['--device', 'cpu'])
    rel = os.path.join('HSN_VOC2012_VGG16', 'hsn_iou.csv')
    _hold(root, ref_root, rel, 'HSN_VOC2012_VGG16',
          registry.get('VOC2012').palette_array(),
          floor=0.999 if ref_round else LABEL_FLOOR)
    assert abs(res['miou'] - ref_res['miou']) <= IOU_TOL
    names = sorted(os.listdir(root / 'out' / 'HSN_VOC2012_VGG16'))
    assert names == sorted(os.listdir(ref_root / 'out' / 'HSN_VOC2012_VGG16'))
    assert len(names) == 4                      # colour + overlay each
    if ref_round:
        assert ((root / 'eval' / rel).read_text()
                == (ref_root / 'eval' / rel).read_text())


def test_hsn_adp_equals_jax(tmp_path, reference):
    ref_root, ref_res = reference('adp')[:2]
    root = _port_root(tmp_path, ref_root)
    for f in ('morph.npy', 'func.npy'):
        os.symlink(ref_root / f, root / f)
    res = hsn_cli.main(RUNS['adp'](root) + ['--device', 'cpu'])
    assert sorted(res) == sorted(ref_res) == ['miou_func', 'miou_morph']
    for htt in ('morph', 'func'):
        _hold(root, ref_root,
              os.path.join('HSN_ADP-morph_X1.7', htt, 'hsn_iou.csv'),
              os.path.join('HSN_ADP-morph_X1.7', htt),
              registry.get(f'ADP-{htt}').palette_array())
        assert abs(res[f'miou_{htt}'] - ref_res[f'miou_{htt}']) <= IOU_TOL


def test_sec_predict_equals_jax(tmp_path, reference, capsys):
    ref_root, ref_res, np_params = reference('sec')
    pred = SECDSRGPredictor.from_flax('SEC', np_params, device='cpu')
    checkpoint.save_checkpoint(
        str(tmp_path / 'wsss' / 'SEC_VOC2012_VGG16'), 40,
        {'params': pred.net.state_dict()})
    res = sec_cli.main(RUNS['sec'](tmp_path) + ['--device', 'cpu'])
    assert 'resumed SEC_VOC2012_VGG16 from step 40' in capsys.readouterr().out
    _hold(tmp_path, ref_root, os.path.join('SEC_VOC2012_VGG16', 'val_iou.csv'),
          'SEC_VOC2012_VGG16', registry.get('VOC2012').palette_array())
    assert abs(res['miou'] - ref_res['miou']) <= IOU_TOL
    for f in ('confusion.png', 'val_iou.xlsx'):
        assert (tmp_path / 'eval' / 'SEC_VOC2012_VGG16' / f).stat().st_size
    overlays = [f for f in os.listdir(tmp_path / 'out' / 'SEC_VOC2012_VGG16')
                if f.endswith('_overlay.png')]
    assert len(overlays) == 2


def test_extract_eval_cli_equals_jax(tmp_path, reference, capsys):
    """The port's aggregator prints the JAX CLI's table over a tree of
    both packages' outputs, each run once, the xlsx siblings skipped."""
    root = tmp_path / 'eval'
    for name in ('voc', 'sec'):
        shutil.copytree(reference(name)[0] / 'eval', root / f'jax_{name}')
    hsn_cli.main(['--dataset', 'DeepGlobe', '--model', 'M7', '--img_size',
                  '24', '--synthetic_n', '2', '--batchsize', '2',
                  '--model_root', str(tmp_path / 'none'), '--eval_root',
                  str(root / 'port'), '--device', 'cpu'])
    capsys.readouterr()
    for argv in (['--eval_root', str(root)],
                 ['--eval_root', str(tmp_path / 'empty')]):
        extract_cli.main(argv)
        got = capsys.readouterr().out
        jax_extract_cli.main(argv)
        assert got == capsys.readouterr().out
    assert got.startswith('no *_iou.csv results under')
    extract_cli.main(['--eval_root', str(root)])
    table = capsys.readouterr().out
    for run in (os.path.join('jax_voc', 'HSN_VOC2012_VGG16', 'hsn_iou.csv'),
                os.path.join('jax_sec', 'SEC_VOC2012_VGG16', 'val_iou.csv'),
                os.path.join('port', 'HSN_DeepGlobe_M7', 'hsn_iou.csv')):
        assert table.count(run) == 1, table
    assert '.xlsx' not in table and len(table.splitlines()) == 4


def _legacy_tree(root):
    for folder in ('DSRG_DeepGlobe_train75_VGG16', 'DSRG_VOC2012_VGG16',
                   'SEC_DeepGlobe_train37.5_M7'):
        (root / folder).mkdir(parents=True)
        for f in (f'{folder}.index', 'checkpoint', 'x_train75_y.data'):
            (root / folder / f).write_text(f)
    (root / 'notes_train75_.txt').write_text('a file at the top level')


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, ds, fs in os.walk(root) for f in fs + ds)


@pytest.mark.parametrize('dry_run', [False, True])
def test_rename_runs_equals_jax(tmp_path, capsys, dry_run):
    flag = ['--dry_run'] if dry_run else []
    for name, cli in (('port', rename_cli), ('jax', jax_rename_cli)):
        _legacy_tree(tmp_path / name)
        cli.main([str(tmp_path / name)] + flag)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].endswith(' 7 entries')
    assert _listing(tmp_path / 'port') == _listing(tmp_path / 'jax')
    assert ('DSRG_DeepGlobe_VGG16' in os.listdir(tmp_path / 'port')) \
        != dry_run
    assert rename_cli._renamed('a_train37.5_b') == 'a_balanced_b'


def test_cli_entry_points_default_to_cuda_including_training(tmp_path,
                                                           monkeypatch):
    """Every command line raises the CUDA error without a card; the
    training tasks run with --device cpu."""
    monkeypatch.chdir(tmp_path)
    argv = ['--dataset', 'DeepGlobe', '--model', 'M7', '--img_size', '16',
            '--synthetic_n', '2', '--model_root', str(tmp_path)]
    train = ['--task', 'train', '--epochs', '1', '--batchsize', '2']
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            hsn_cli.main(argv)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            sec_cli.main(argv + ['--task', 'predict'])
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            sec_cli.main(argv + train)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            train_cli.main(argv + train)
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            hsn_cli.main(argv + ['--mesh', 'auto'])
    sec_cli.main(argv + train + ['--device', 'cpu'])
    assert (tmp_path / 'log' / 'SEC_DeepGlobe_M7' / 'train.jsonl').is_file()
    train_cli.main(argv + train + ['--device', 'cpu'])
    assert (tmp_path / 'DeepGlobe_M7' / 'DeepGlobe_M7.npz').is_file()
    # --mesh auto on the one CPU: a one-shard mesh, the same csv
    hsn_cli.main(argv + ['--device', 'cpu'])
    csv = tmp_path / 'eval' / 'HSN_DeepGlobe_M7' / 'hsn_iou.csv'
    single = csv.read_text()
    hsn_cli.main(argv + ['--mesh', 'auto', '--device', 'cpu'])
    assert csv.read_text() == single
    with pytest.raises(NotImplementedError, match='item 8b'):
        train_cli.main(argv + train + ['--device', 'cpu', '--mesh', 'auto'])
