"""The port's host-side data layer, artifact IO and report writers against
the JAX package's: the same fake devkits and arrays through both, outputs
held equal (these modules are numpy + PIL copies)."""
import os

import numpy as np
import pytest
from PIL import Image

from test_pipeline import _fake_voc_devkit
from wsss_tpu.data import cls_labels as jax_cls_labels
from wsss_tpu.data import pipeline as jax_pipeline
from wsss_tpu.eval import reports as jax_reports
from wsss_tpu.io import artifacts as jax_artifacts
from wsss_tpu_torch.data import cls_labels, pipeline, registry
from wsss_tpu_torch.eval import reports
from wsss_tpu_torch.io import artifacts


def _batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.indices, y.indices)
        assert x.names == y.names
        for k in ('images', 'tags', 'gt'):
            u, v = getattr(x, k), getattr(y, k)
            assert (u is None) == (v is None), k
            if u is not None:
                np.testing.assert_array_equal(u, v)


def test_devkit_loader_equals_jax(tmp_path):
    _fake_voc_devkit(str(tmp_path))
    ours = pipeline.DevkitDataset(registry.get('VOC2012'), str(tmp_path),
                                  'val', size=20, seed=4)
    ref = jax_pipeline.DevkitDataset(
        jax_pipeline.get_spec('VOC2012'), str(tmp_path), 'val', size=20,
        seed=4)
    assert ours.names == ref.names
    np.testing.assert_array_equal(ours.split_tags(), ref.split_tags())
    _batches_equal(ours.batches(2, with_gt=True),
                   ref.batches(2, with_gt=True))
    _batches_equal(ours.batches(2, shuffle=True),
                   ref.batches(2, shuffle=True))
    _batches_equal(ours.iter_native(with_gt=True),
                   ref.iter_native(with_gt=True))
    assert isinstance(pipeline.open_dataset('VOC2012', str(tmp_path), 'val',
                                            20), pipeline.DevkitDataset)


def test_open_dataset_falls_back_to_synthetic(tmp_path):
    for root in (None, str(tmp_path)):
        ds = pipeline.open_dataset('DeepGlobe', root, 'val', 24,
                                   synthetic_n=5)
        ref = jax_pipeline.open_dataset('DeepGlobe', root, 'val', 24,
                                        synthetic_n=5)
        assert isinstance(ds, pipeline.SyntheticWSSS)
        _batches_equal(ds.batches(2), ref.batches(2))
        _batches_equal(ds.batches(3, shuffle=True, with_gt=False),
                       ref.batches(3, shuffle=True, with_gt=False))
        _batches_equal(ds.iter_native(with_gt=True),
                       ref.iter_native(with_gt=True))
        np.testing.assert_array_equal(ds.split_tags(), ref.split_tags())


def test_prefetch_order_and_errors():
    assert list(pipeline.prefetch(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise ValueError('inside the producer')
    it = pipeline.prefetch(boom())
    assert next(it) == 1
    with pytest.raises(ValueError, match='inside the producer'):
        next(it)


def test_cls_labels_equal_jax(tmp_path):
    names = ['a', 'b.jpg', 'c']
    tags = np.eye(3, 5, dtype=np.float32)
    path = cls_labels.save_cache(str(tmp_path), names, tags, split='s')
    assert os.path.basename(path) == 'cls_labels_s.npy'
    np.testing.assert_array_equal(
        cls_labels.load_cache(str(tmp_path), 's', names),
        jax_cls_labels.load_cache(str(tmp_path), 's', names))
    gts = []
    for i, name in enumerate(names):
        gt = np.zeros((8, 8), np.uint8)
        gt[:i + 1] = 2 * i + 1
        gts.append(str(tmp_path / f'{i}.png'))
        Image.fromarray(gt).save(gts[-1])
    np.testing.assert_array_equal(cls_labels.tags_from_gt(gts, 5),
                                  jax_cls_labels.tags_from_gt(gts, 5))
    ann = tmp_path / 'Annotations'
    ann.mkdir()
    (ann / 'a.xml').write_text('<annotation><object><name>cat</name>'
                               '</object></annotation>')
    assert cls_labels.tags_from_voc_xml(str(ann), ['a'], ['dog', 'cat']
                                        ).tolist() == [[0.0, 1.0]]
    assert cls_labels.tags_from_voc_xml(str(ann), ['a', 'z'], ['cat']) \
        is None


def test_cue_pickle_and_cam_npy_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    onehot = rng.random((2, 41, 41, 5)) > 0.9
    inds = [np.array([1, 3]), np.array([], np.int64)]
    ours = artifacts.pack_cues(onehot, inds, [4, 9])
    ref = jax_artifacts.pack_cues(onehot, inds, [4, 9])
    assert list(ours) == list(ref)
    p_ours, p_ref = tmp_path / 'o' / 'c.pickle', tmp_path / 'r' / 'c.pickle'
    artifacts.write_cue_pickle(str(p_ours), ours)
    jax_artifacts.write_cue_pickle(str(p_ref), ref)
    assert p_ours.read_bytes() == p_ref.read_bytes()
    back = jax_artifacts.read_cue_pickle(str(p_ours))
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])
    for idx in (4, 9, 5):
        np.testing.assert_array_equal(
            artifacts.unpack_cues(ours, idx, (41, 41, 5)),
            jax_artifacts.unpack_cues(ref, idx, (41, 41, 5)))
    keys, cam = np.array([0, 2]), rng.random((2, 6, 7)).astype(np.float32)
    artifacts.write_cam_npy(str(tmp_path / 'cam' / 'x.npy'), keys, cam,
                            high_res=cam * 2)
    d = jax_artifacts.read_cam_npy(str(tmp_path / 'cam' / 'x.npy'))
    np.testing.assert_array_equal(d['high_res'], cam * 2)
    assert set(artifacts.read_cam_npy(str(tmp_path / 'cam' / 'x.npy'))) == \
        {'keys', 'cam', 'high_res'}


def test_report_writers_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 23, (9, 11))
    labels[0, 0] = 255
    pal = registry.get('VOC2012').palette_array()
    for kw in ({}, {'ignore_color': (255, 255, 255)}):
        np.testing.assert_array_equal(reports.colorize(labels, pal, **kw),
                                      jax_reports.colorize(labels, pal, **kw))
    img = rng.uniform(0, 255, (9, 11, 3)).astype(np.float32)
    color = reports.colorize(labels, pal)
    np.testing.assert_array_equal(reports.overlay(img, color, 0.25),
                                  jax_reports.overlay(img, color, 0.25))
    reports.save_png(str(tmp_path / 'o' / 'a.png'), color)
    jax_reports.save_png(str(tmp_path / 'r' / 'a.png'), color)
    assert (tmp_path / 'o' / 'a.png').read_bytes() == \
        (tmp_path / 'r' / 'a.png').read_bytes()
    iou = np.array([0.5, np.nan, 0.25])
    prec, rec = np.array([0.1, 0.2, 0.3]), np.array([0.3, 0.2, 0.1])
    for extra in ((), (prec, rec)):
        m = reports.write_iou_csv(str(tmp_path / 'o' / 'i.csv'),
                                  ['x', 'y', 'z'], iou, *extra)
        m_j = jax_reports.write_iou_csv(str(tmp_path / 'r' / 'i.csv'),
                                        ['x', 'y', 'z'], iou, *extra)
        assert m == m_j == pytest.approx(0.375)
        assert (tmp_path / 'o' / 'i.csv').read_text() == \
            (tmp_path / 'r' / 'i.csv').read_text()
