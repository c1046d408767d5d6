"""The port's xlsx reader/writer, report writers and metrics against the
JAX package's: the same numpy inputs through both, outputs held equal —
csv text equal, xlsx tables equal, each package reads the other's xlsx,
thresholds equal, float metrics within 1e-6."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_xlsx import _write_pandas_style_xlsx
from wsss_tpu.eval import metrics as jax_metrics
from wsss_tpu.eval import reports as jax_reports
from wsss_tpu.eval import xlsx as jax_xlsx
from wsss_tpu_torch.eval import metrics, reports, xlsx

ROWS = [[None, 'Class', 'IoU'],
        [0, 'background', 0.5],
        [1, 'a&b <c>', -1],
        [2, 'ünïcode', 12345],
        [3, 'nan', float('nan')],
        [4, 'Mean', 0.123456789]]


def test_xlsx_cells_round_trip(tmp_path):
    path = str(tmp_path / 't.xlsx')
    xlsx.write_xlsx(path, ROWS)
    back = xlsx.read_xlsx(path)
    assert back[:4] == ROWS[:4]
    assert back[4] == [3, 'nan']           # non-finite numbers stay blank
    assert back[5][1] == 'Mean' and back[5][2] == 0.123456789
    cols = {'Class': ['bg', 'fg', 'Mean'], 'IoU': [0.25, 0.75, 0.5]}
    path = str(tmp_path / 'table.xlsx')
    xlsx.write_table_xlsx(path, cols)
    assert xlsx.read_table_xlsx(path) == cols
    raw = xlsx.read_xlsx(path)
    assert raw[0][0] is None and [r[0] for r in raw[1:]] == [0, 1, 2]
    assert xlsx.table_mean_value(path) == 0.5
    assert xlsx.table_mean_value(str(tmp_path / 'missing.xlsx')) is None
    for i in (0, 1, 25, 26, 51, 701, 702):
        assert xlsx._col_name(i) == jax_xlsx._col_name(i)
        assert xlsx._col_index(xlsx._col_name(i) + '13') == i


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_xlsx_crosses_between_packages(tmp_path, writer):
    """Each package reads the other's file, the pandas-style shared
    strings file too, cell for cell."""
    w, r = (xlsx, jax_xlsx) if writer == 'port' else (jax_xlsx, xlsx)
    path = str(tmp_path / 'x.xlsx')
    w.write_xlsx(path, ROWS)
    assert r.read_xlsx(path) == w.read_xlsx(path)
    cols = {'HTT': ['c1', 'Average'], 'TPR': [0.9, 0.8]}
    w.write_table_xlsx(path, cols)
    assert r.read_table_xlsx(path) == cols
    _write_pandas_style_xlsx(str(tmp_path / 'ref.xlsx'))
    assert (xlsx.read_table_xlsx(str(tmp_path / 'ref.xlsx'))
            == jax_xlsx.read_table_xlsx(str(tmp_path / 'ref.xlsx')))
    for path in (str(tmp_path / 'ref.xlsx'), path):
        assert (xlsx.table_mean_value(path)
                == jax_xlsx.table_mean_value(path))
    assert xlsx.table_mean_value(str(tmp_path / 'ref.xlsx')) == 0.31298


@pytest.mark.parametrize('with_pr', [False, True])
def test_table_writers_equal_jax(tmp_path, with_pr):
    names = ['bg', 'cat', 'dog', 'a,b']
    iou = np.array([0.9, 0.5, np.nan, 1 / 3])
    pr = ((np.array([1, .5, 0., .25]), np.array([.9, .4, 0., .75]))
          if with_pr else (None, None))
    out = {}
    for name, mod in (('port', reports), ('jax', jax_reports)):
        d = tmp_path / name
        miou = mod.write_iou_csv(str(d / 'run' / 'val_iou.csv'), names,
                                 iou, *pr)
        mod.write_metrics_csv(str(d / 'm' / 'sess_metrics.csv'), names,
                              {'TPR': np.array([0.9, 0.7, 0.1, 0.5]),
                               'F1': np.array([0.6, np.nan, 0.2, 0.4])})
        out[name] = (d, miou)
    (d, miou), (dj, miou_j) = out['port'], out['jax']
    assert miou == miou_j
    for rel in ('run/val_iou', 'm/sess_metrics'):
        assert ((d / (rel + '.csv')).read_text()
                == (dj / (rel + '.csv')).read_text())
        got = jax_xlsx.read_table_xlsx(str(d / (rel + '.xlsx')))
        want = xlsx.read_table_xlsx(str(dj / (rel + '.xlsx')))
        assert got == want and len(got) >= 2


def test_extract_eval_mixed_tree_equals_jax(tmp_path):
    """A tree of port csv outputs (with their xlsx siblings, not counted
    twice), JAX package outputs, a reference-produced xlsx and the
    temporary file the reference skips."""
    root = tmp_path / 'eval'
    reports.write_iou_csv(str(root / 'runA' / 'val_iou.csv'), ['bg', 'fg'],
                          np.array([0.2, 0.6]))
    jax_reports.write_iou_csv(str(root / 'runB' / 'test_iou.csv'),
                              ['bg', 'fg'], np.array([0.1, 0.3]))
    ref_dir = root / 'SEC' / 'VOC2012'
    ref_dir.mkdir(parents=True)
    _write_pandas_style_xlsx(str(ref_dir / 'metrics_VOC.xlsx'))
    _write_pandas_style_xlsx(str(ref_dir / '~metrics_VOC.xlsx'))
    rows = reports.extract_eval(str(root))
    assert rows == jax_reports.extract_eval(str(root))
    got = {r['run']: r['miou'] for r in rows}
    assert got == {os.path.join('runA', 'val_iou.csv'): '0.40000',
                   os.path.join('runB', 'test_iou.csv'): '0.20000',
                   os.path.join('SEC', 'VOC2012', 'metrics_VOC.xlsx'):
                       '0.31298'}


@pytest.mark.parametrize('label_hw', [(12, 14), (6, 7)])
def test_save_color_and_overlay_equals_jax(tmp_path, label_hw):
    """Equal PNG bytes; the colour mask is nearest-resized to the image
    where the two differ."""
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 4, label_hw)
    labels[0, 0] = 255
    pal = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    img = rng.integers(0, 256, (12, 14, 3)).astype(np.uint8)
    for name, mod in (('port', reports), ('jax', jax_reports)):
        mod.save_color_and_overlay(str(tmp_path / name), 'a', labels, pal,
                                   img, r=0.25)
        mod.save_color_and_overlay(str(tmp_path / name), 'b', labels, pal)
    assert sorted(os.listdir(tmp_path / 'port')) == ['a.png',
                                                    'a_overlay.png', 'b.png']
    for f in os.listdir(tmp_path / 'jax'):
        assert ((tmp_path / 'port' / f).read_bytes()
                == (tmp_path / 'jax' / f).read_bytes()), f
    over = np.asarray(Image.open(tmp_path / 'port' / 'a_overlay.png'))
    assert over.shape == img.shape


def test_plots_equal_jax(tmp_path):
    """The heatmap and the ROC plot: PNG files equal to the JAX
    package's byte for byte (the same matplotlib calls)."""
    rng = np.random.default_rng(0)
    target = (rng.random((50, 3)) > 0.5).astype(np.float32)
    scores = rng.random((50, 3)).astype(np.float32)
    for name, mod in (('port', reports), ('jax', jax_reports)):
        mod.confusion_heatmap(str(tmp_path / name / 'cm.png'),
                              np.array([[5, 1], [2, 8]]), ['a', 'b'])
        mod.plot_rocs(str(tmp_path / name / 'roc.png'), target, scores,
                      ['a', 'b', 'c'])
    for f in ('cm.png', 'roc.png'):
        with Image.open(tmp_path / 'port' / f) as im:
            assert im.format == 'PNG' and min(im.size) > 100
        assert ((tmp_path / 'port' / f).read_bytes()
                == (tmp_path / 'jax' / f).read_bytes()), f


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_precision_recall_and_iou_update_equal_jax():
    rng = np.random.default_rng(5)
    conf = rng.integers(0, 50, (6, 6))
    conf[2] = 0
    conf[:, 2] = 0                              # an absent class
    p, r = metrics.precision_recall_from_confusion(torch.from_numpy(conf))
    pj, rj = jax_metrics.precision_recall_from_confusion(conf)
    assert p.dtype == r.dtype == np.float64
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(r, rj)
    c = 5
    inter, union = np.zeros(c, np.int64), np.zeros(c, np.int64)
    inter_j, union_j = _jnp(inter.astype(np.int32), inter.astype(np.int32))
    for _ in range(3):
        pred = rng.random((2, 9, 11, c)) > 0.6
        gt = rng.random((2, 9, 11, c)) > 0.5
        inter, union = metrics.iou_update(inter, union,
                                          torch.from_numpy(pred),
                                          torch.from_numpy(gt))
        inter_j, union_j = jax_metrics.iou_update(inter_j, union_j,
                                                  *_jnp(pred, gt))
    np.testing.assert_array_equal(inter.numpy(), np.asarray(inter_j))
    np.testing.assert_array_equal(union.numpy(), np.asarray(union_j))


@pytest.mark.parametrize('seed', [0, 1])
def test_classification_metrics_equal_jax(seed):
    """batch_f1, optimal_thresholds (the 512-point grid and the 256-point
    one), thresholded_metrics: thresholds equal, floats within 1e-6."""
    rng = np.random.default_rng(seed)
    n, c = 300, 7
    target = (rng.random((n, c)) > 0.6).astype(np.float32)
    target[:, 3] = 0                            # a class with no positive
    scores = np.clip(0.35 * target + rng.random((n, c)) * 0.7, 0, 1
                     ).astype(np.float32)
    scores[:5] = np.round(scores[:5] * 4) / 4   # scores on grid points
    f1 = metrics.batch_f1(torch.from_numpy(target), torch.from_numpy(scores))
    f1_j = jax_metrics.batch_f1(*_jnp(target, scores))
    assert f1.dtype == torch.float32
    assert abs(float(f1) - float(f1_j)) <= 1e-6
    for num in (512, 256):
        th = metrics.optimal_thresholds(target, torch.from_numpy(scores),
                                        num_thresholds=num)
        th_j = np.asarray(jax_metrics.optimal_thresholds(target, scores,
                                                         num_thresholds=num))
        assert th.dtype == torch.float32 and th.shape == (c,)
        np.testing.assert_array_equal(th.numpy(), th_j)
        grid = metrics._threshold_grid(num, 'cpu')
        np.testing.assert_array_equal(grid.numpy(),
                                      np.asarray(jnp.linspace(0, 1, num)))
    got = metrics.thresholded_metrics(torch.from_numpy(target),
                                      torch.from_numpy(scores), th)
    want = jax_metrics.thresholded_metrics(target, scores, th_j)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                   equal_nan=True, err_msg=k)
