"""The program's spans (``utils.timing.span``) at each entry point:
without a profiler no range is opened; under ``profile_trace`` every
entry writes ranges named from ``SPANS``, once per unit of work and
nested as the stages nest; the outputs are the same bits either way."""
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from wsss_tpu_torch.cli import sec_dsrg as sec_cli
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.methods.gradcam_cues import (VOCDeepGlobeCueGenerator,
                                                 _ClassifierHandle)
from wsss_tpu_torch.ops.crf import config, meanfield
from wsss_tpu_torch.parallel.mesh import Mesh
from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor, SECDSRGTrainer
from wsss_tpu_torch.utils import timing

CPU = torch.device('cpu')
VOC = registry.get('VOC2012')
HSN_SIZE = 104          # the smallest size whose CRF takes the grid
HSN_ITERS = 2
# ADP's CRFs on the direct window at a size the suite affords: bi_sxy 2
# (radius 6, 113 offsets) where ADP's 10 has 2821, which in the suite's
# workers takes minutes; the route and the spans are the same
ADP_CRFS = (config.CRFConfig(1, 20, 2, 40, 50, 5),
            config.CRFConfig(3, 40, 2, 4, 25, 5))


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _hsn():
    fg, bg = (_ClassifierHandle.random('M7', 20, HSN_SIZE, seed=s,
                                       device='cpu') for s in (0, 1))
    cfg = config.CRFConfig(
        *config.hsn_config('VOC2012', 'VGG16').astuple()[:5], HSN_ITERS)
    seg = hsn.HSNSegmenter(VOC, fg, bg, cfg=cfg, device='cpu')
    imgs = _images(0, (2, HSN_SIZE, HSN_SIZE, 3))
    return lambda: [seg.segment_batch(imgs)]


def _adp():
    handle = _ClassifierHandle.random('X1.7', 51, HSN_SIZE, seed=2,
                                      device='cpu')
    seg = hsn.ADPHSNSegmenter(handle, 'X1.7', *ADP_CRFS, device='cpu')
    imgs = _images(4, (1, HSN_SIZE, HSN_SIZE, 3))
    imgs[:, :, :20] = 250          # glass, for the synthetic background
    return lambda: list(seg.segment_batch(imgs))


def _predict():
    pred = SECDSRGPredictor.random('SEC', 21, device='cpu')
    img = _images(1, (120, 110, 3))
    return lambda: [sec_cli.predict_image(pred, VOC, 'SEC', img,
                                          img.shape[:2], size=65)]


def _train(shards):
    def prepare():
        trainer = SECDSRGTrainer('SEC', 21, device='cpu')
        trainer.init(torch.Generator().manual_seed(0))
        raw = torch.as_tensor(_images(2, (2, 65, 65, 3)),
                              dtype=torch.float32)
        cues = np.zeros((2, 9, 9, 21), np.float32)
        cues[:, :3, :, 0] = 1.0
        cues[:, 6:, :, 5] = 1.0
        tags = np.zeros((2, 21), np.float32)
        tags[:, [0, 5]] = 1.0
        mesh = None if shards == 1 else Mesh([CPU] * shards, ('data',))

        def call():
            parts = trainer.train_step(
                (raw - 120.0) / 60.0, raw, cues, tags,
                torch.Generator().manual_seed(1), mesh=mesh)
            return (list(parts.values())
                    + [p.detach() for p in trainer.net.parameters()])
        return call
    return prepare


def _cues():
    fg, bg = (_ClassifierHandle.random('M7', 20, 32, seed=s, device='cpu')
              for s in (0, 1))
    gen = VOCDeepGlobeCueGenerator(VOC, fg, bg, device='cpu')
    tags = np.zeros((2, 20), np.float32)
    tags[:, [3, 7]] = 1.0
    batch = types.SimpleNamespace(images=_images(3, (2, 32, 32, 3)),
                                  tags=tags, indices=[0, 1])

    def call():
        out = gen.run([batch])
        return [out[k] for k in sorted(out)]
    return call


# each entry: a function that makes a fresh zero-argument call
ENTRIES = {'hsn': _hsn, 'adp': _adp, 'predict': _predict,
           'train': _train(1), 'train_mesh': _train(2), 'cues': _cues}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(a, b)


def _spans(tmp_path, call):
    """(outputs, the program's ranges as (name, start, end, tid))."""
    with timing.profile_trace(str(tmp_path)):
        out = call()
    with open(tmp_path / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    spans = [(e['name'], float(e['ts']), float(e['ts']) + float(e['dur']),
              e['tid']) for e in events
             if e.get('cat') == 'user_annotation'
             and e['name'].startswith('wsss.')]
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer, any_thread=False) -> bool:
    return (outer[1] <= inner[1] and inner[2] <= outer[2]
            and (any_thread or inner[3] == outer[3]))


def _each_inside(spans, inner, outer, count=None, any_thread=False):
    """Every ``inner`` span lies inside some ``outer`` span, on the same
    thread unless ``any_thread``; ``count`` of them in all where given."""
    ins, outs = _named(spans, inner), _named(spans, outer)
    assert ins and outs, (inner, outer)
    assert all(any(_inside(i, o, any_thread) for o in outs)
               for i in ins), (inner, outer)
    if count is not None:
        assert len(ins) == count, (inner, len(ins))


def _crf_nested(spans, entry, iterations, calls=1,
                filter_span='wsss.grid.filter'):
    """The CRF's spans as ``span``'s table nests them: build and loop
    inside each mean_field call, that inside the entry's span, and one
    filter (``filter_span``) for the normalizer and one an iteration."""
    _each_inside(spans, 'wsss.crf.mean_field', entry, calls)
    for part in ('wsss.crf.build', 'wsss.crf.loop'):
        _each_inside(spans, part, 'wsss.crf.mean_field', calls)
    _each_inside(spans, filter_span, 'wsss.crf.mean_field',
                 (iterations + 1) * calls)
    for part, each in (('wsss.crf.build', 1),
                       ('wsss.crf.loop', iterations)):
        parts = _named(spans, part)
        inner = [f for f in _named(spans, filter_span)
                 if any(_inside(f, p) for p in parts)]
        assert len(inner) == each * calls, part


def test_span_opens_nothing_without_a_profiler():
    assert timing.span('wsss.cam') is timing.span('wsss.crf.loop')
    with timing.span('wsss.cam') as inside:
        assert inside is None
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        assert isinstance(timing.span('wsss.cam'),
                          torch.profiler.record_function)


def test_every_span_in_the_program_is_listed():
    """The names the package passes to ``span`` are ``SPANS``, each once
    listed and each opened somewhere."""
    root = pathlib.Path(timing.__file__).resolve().parents[1]
    used = set()
    for path in root.rglob('*.py'):
        used |= set(re.findall(r"span\('([^']+)'\)", path.read_text()))
    assert len(set(timing.SPANS)) == len(timing.SPANS)
    assert used == set(timing.SPANS)
    assert all(n.startswith('wsss.') for n in timing.SPANS)


@pytest.mark.parametrize('entry', sorted(ENTRIES))
def test_no_profiler_no_record_function(entry, monkeypatch):
    call = ENTRIES[entry]()

    def refuse(name):
        raise AssertionError(f'record_function({name!r}) without a '
                             'profiler')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert call()


@pytest.mark.parametrize('entry', sorted(ENTRIES))
def test_outputs_equal_with_and_without_profiler(entry, tmp_path):
    plain = ENTRIES[entry]()()
    traced, spans = _spans(tmp_path, ENTRIES[entry]())
    assert spans
    assert len(plain) == len(traced)
    assert all(_same(a, b) for a, b in zip(plain, traced))


@pytest.mark.parametrize('entry', sorted(ENTRIES))
def test_spans_nest_as_the_stages(entry, tmp_path):
    _, spans = _spans(tmp_path, ENTRIES[entry]())
    assert {s[0] for s in spans} <= set(timing.SPANS)
    if entry == 'hsn':
        top = 'wsss.hsn.segment_batch'
        assert len(_named(spans, top)) == 1
        _each_inside(spans, 'wsss.io.to_device', top, 1)
        _each_inside(spans, 'wsss.cam', top, 2)
        _crf_nested(spans, top, HSN_ITERS)
    elif entry == 'adp':
        top = 'wsss.hsn.segment_batch'
        assert len(_named(spans, top)) == 1
        _each_inside(spans, 'wsss.io.to_device', top, 1)
        _each_inside(spans, 'wsss.cam', top, 1)
        iters = {c.iterations for c in ADP_CRFS}.pop()
        _crf_nested(spans, top, iters, calls=2,
                    filter_span='wsss.window.filter')
        assert not _named(spans, 'wsss.grid.filter')
    elif entry == 'predict':
        top = 'wsss.sec.predict_image'
        assert len(_named(spans, top)) == 1
        _each_inside(spans, 'wsss.io.to_device', top, 1)
        _each_inside(spans, 'wsss.sec.fcn', top, 1)
        _each_inside(spans, 'wsss.net.atrous', 'wsss.sec.fcn', 1)
        _crf_nested(spans, top, config.SEC_TEST['VOC2012'].iterations)
    elif entry.startswith('train'):
        top = 'wsss.train.step'
        shards = 2 if entry == 'train_mesh' else 1
        assert len(_named(spans, top)) == 1
        for name in ('wsss.train.backward', 'wsss.train.optimizer'):
            _each_inside(spans, name, top, 1)
        _each_inside(spans, 'wsss.train.forward', top, shards,
                     any_thread=True)
        _each_inside(spans, 'wsss.train.losses', 'wsss.train.forward',
                     shards)
        _each_inside(spans, 'wsss.net.atrous', 'wsss.train.forward',
                     shards)
        _crf_nested(spans, 'wsss.train.losses',
                    config.SEC_TRAIN_DEFAULT.iterations, shards)
        threads = {s[3] for s in _named(spans, 'wsss.train.forward')}
        assert len(threads) == shards
        waits = _named(spans, 'wsss.mesh.wait')
        assert bool(waits) == (shards > 1)
    else:
        top = 'wsss.cues.batch'
        assert len(_named(spans, top)) == 1
        _each_inside(spans, 'wsss.io.to_device', top, 2)
        _each_inside(spans, 'wsss.cam', top, 2)
        _each_inside(spans, 'wsss.io.to_host', top, 1)


@pytest.mark.parametrize('profiled', [False, True])
def test_window_offsets_count_every_filter(profiled, tmp_path):
    """``WINDOW_OFFSETS`` grows by the window's offsets at each filter:
    K (counted here by brute force) times the normalizer and the
    iterations of both CRFs, with a profiler or without."""
    call = _adp()
    before = meanfield.WINDOW_OFFSETS
    if profiled:
        _spans(tmp_path, call)
    else:
        call()
    want = 0
    for c in ADP_CRFS:
        r = 3 * c.bi_sxy
        k = sum(1 for dy in range(-r, r + 1) for dx in range(-r, r + 1)
                if dy * dy + dx * dx <= r * r)
        want += k * (c.iterations + 1)
    assert want == 113 * 12
    assert meanfield.WINDOW_OFFSETS - before == want
