"""The port's device mesh (``wsss_tpu_torch/parallel/mesh.py``) and the
mesh branches of HistoSegNet and the command lines, on CPU shards.

The fixture ``cpu_shards`` makes ``make_mesh(device='cpu')`` see 8 CPU
devices, as tests/conftest.py gives JAX 8 host devices; the JAX side uses
that virtual mesh.  The first five tests port tests/test_mesh_prefetch.py.

The command lines' --mesh runs are in tests/test_torch_cli_mesh.py (a file
of their own, so that the suite's workers run the two in parallel).

HistoSegNet's VOC bg channel takes a max over the batch.  The reference
takes it per shard where its fused per-shard step runs (the CRF config
takes the grid, which its CPU path does only with
``meanfield._MXU_FORCE_INTERPRET``) and over the whole batch elsewhere;
the port routes as the reference's TPU does.  So the grid case holds the
port against the JAX fused step with that switch on (labels >= 0.99, the
bound of tests/test_torch_hsn.py) and against single-device runs of each
shard's images (equal); the other cases against the JAX global program
and the port's single-device run.  The command lines run at 32^2, where
no config takes the grid, so their sharded outputs equal --mesh none's,
as in tests/test_cli_mesh.py."""
import numpy as np
import pytest
import torch

from test_torch_gradcam import bridged_handles
from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.data import registry as jax_registry
from wsss_tpu.methods import hsn as jax_hsn
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu.ops.crf.config import CRFConfig as JaxCRFConfig
from wsss_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.parallel import mesh as mesh_mod
from wsss_tpu_torch.parallel.mesh import (Mesh, batch_sharding, make_mesh,
                                          map_shards, mesh_batches,
                                          prefetch_to_mesh, shard_batch)

CPU = torch.device('cpu')
LABEL_FLOOR = 0.99


@pytest.fixture
def cpu_shards(monkeypatch):
    """8 CPU shards for ``make_mesh(device='cpu')``."""
    real = mesh_mod.visible_devices
    monkeypatch.setattr(mesh_mod, 'visible_devices',
                        lambda kind: [CPU] * 8 if kind == 'cpu'
                        else real(kind))


class _B:
    def __init__(self, i, n=3):
        rng = np.random.default_rng(i)
        self.images = rng.uniform(0, 255, (n, 8, 8, 3)).astype(np.float32)


def test_prefetch_matches_serial_shard_batch(cpu_shards):
    """Order, padding and placement match the serial path."""
    mesh = make_mesh(2, axis_names=('data',), device='cpu')
    batches = [_B(0), _B(1, n=5), _B(2, n=1)]   # 5 and 1 need padding
    got = list(prefetch_to_mesh(mesh, batches,
                                lambda b: (b.images,), depth=2))
    assert len(got) == len(batches)
    for b, (orig, (placed,), b0) in zip(batches, got):
        assert orig is b
        assert b0 == b.images.shape[0]
        assert placed.shape[0] % 2 == 0            # padded to shards
        assert placed.placement == batch_sharding(mesh)
        (serial,), _ = shard_batch(mesh, b.images)
        for p, s in zip(placed.pieces, serial.pieces):
            assert torch.equal(p, s)
        np.testing.assert_array_equal(placed.gather().numpy()[:b0],
                                      b.images)


def test_prefetch_surfaces_producer_errors(cpu_shards):
    mesh = make_mesh(2, axis_names=('data',), device='cpu')

    def bad():
        yield _B(0)
        raise RuntimeError('loader died')

    it = prefetch_to_mesh(mesh, bad(), lambda b: (b.images,))
    next(it)
    with pytest.raises(RuntimeError, match='loader died'):
        list(it)


def test_mesh_batches_none_passthrough():
    batches = [_B(0), _B(1)]
    got = list(mesh_batches(None, batches, lambda b: (b.images,)))
    for b, (orig, (arr,), b0) in zip(batches, got):
        assert orig is b and arr is b.images and b0 == 3


def test_shard_batch_ships_uint8_unconverted(cpu_shards):
    """uint8, int and bool ship as they are; only float64 narrows.  A
    value already placed on the mesh passes through."""
    mesh = make_mesh(2, axis_names=('data',), device='cpu')
    u8 = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    f64 = np.ones((2, 3), np.float64)
    flags = np.array([True, False])
    (a, b, c), b0 = shard_batch(mesh, u8, f64, flags)
    assert a.dtype == torch.uint8 and b0 == 2
    assert b.dtype == torch.float32
    assert c.dtype == torch.bool
    np.testing.assert_array_equal(a.gather().numpy(), u8)
    (again,), _ = shard_batch(mesh, a)
    assert again is a


def test_fused_hsn_accepts_uint8_transport(cpu_shards):
    """Integer images label the same shipped as float32 or as uint8 on a
    mesh (the cast on the device is exact for 0..255), on the grid route
    (DeepGlobe: no bg net, so nothing reduces over the batch)."""
    size = 112
    cfg = config.CRFConfig(1.5, 3, 40.0, 40.0, 10.0, iterations=2)
    spec = registry.get('DeepGlobe')
    _, fg = bridged_handles('M7', spec.n_fg_classes, size, seed=2)
    seg = hsn.HSNSegmenter(spec, fg, cfg=cfg, drop_last_class=True,
                           device='cpu')
    mesh = make_mesh(2, axis_names=('data',), device='cpu')
    assert seg.per_shard(mesh)
    u8 = np.random.default_rng(3).integers(
        0, 256, (2, size, size, 3)).astype(np.uint8)
    lab_f32 = seg.segment_batch(u8.astype(np.float32)).numpy()
    lab_u8 = seg.segment_batch(u8, mesh=mesh).numpy()
    assert (lab_u8 == lab_f32).mean() > 0.995


def test_make_mesh_shapes(cpu_shards):
    m = make_mesh(device='cpu')
    assert m.axis_names == ('data', 'model')
    assert m.shape == {'data': 8, 'model': 1} and m.size == 8
    assert make_mesh(8, model=2, device='cpu').shape == {'data': 4,
                                                        'model': 2}
    assert make_mesh(4, ('data',), device='cpu').shape == {'data': 4}
    with pytest.raises(ValueError, match='must divide'):
        make_mesh(6, model=4, device='cpu')


def test_make_mesh_takes_at_most_the_visible_devices(cpu_shards):
    assert make_mesh(16, device='cpu').shape == {'data': 8, 'model': 1}


def test_one_cpu_is_a_one_shard_mesh():
    assert make_mesh(2, device='cpu').shape == {'data': 1, 'model': 1}


def test_cuda_mesh_goes_through_resolve_device():
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert make_mesh(device='cuda').shape == {'data': n, 'model': 1}
        return
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_mesh(device='cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        Mesh([torch.device('cuda', 0)] * 2, ('data',))


def test_shard_batch_pads_by_the_last_row(cpu_shards):
    mesh = make_mesh(4, axis_names=('data',), device='cpu')
    x = np.arange(5 * 2, dtype=np.int64).reshape(5, 2)
    (s,), b0 = shard_batch(mesh, x)
    assert b0 == 5 and s.shape == (8, 2)
    assert [tuple(p.shape) for p in s.pieces] == [(2, 2)] * 4
    full = s.gather().numpy()
    np.testing.assert_array_equal(full[:5], x)
    np.testing.assert_array_equal(full[5:], np.repeat(x[-1:], 3, 0))
    x[:] = -1                              # the pieces are copies
    assert int(s.gather().min()) >= 0


def test_map_shards_gathers_in_shard_order(cpu_shards):
    mesh = make_mesh(3, axis_names=('data',), device='cpu')
    x = torch.arange(5.0)[:, None]
    (s,), b0 = shard_batch(mesh, x)
    seen = []

    def fn(dev, piece, k):
        seen.append(dev)
        return piece * k, piece + k

    a, b = map_shards(mesh, fn, s, [10, 20, 30], b0=b0)
    assert seen == [CPU] * 3
    np.testing.assert_array_equal(a[:, 0].numpy(), [0, 10, 40, 60, 120])
    np.testing.assert_array_equal(b[:, 0].numpy(), [10, 11, 22, 23, 34])


@pytest.fixture
def interpret_mxu(monkeypatch):
    monkeypatch.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)


def _voc_segmenters(cfg, size):
    spec = registry.get('VOC2012')
    n = spec.n_fg_classes
    jfg, tfg = bridged_handles('M7', n, size, seed=0)
    jbg, tbg = bridged_handles('M7', n, size, seed=1)
    jseg = jax_hsn.HSNSegmenter(jax_registry.get('VOC2012'), jfg, jbg,
                                cfg=JaxCRFConfig(*cfg))
    tseg = hsn.HSNSegmenter(spec, tfg, tbg, cfg=config.CRFConfig(*cfg),
                            device='cpu')
    return jseg, tseg


def _images(n, size, seed=9):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def test_hsn_grid_route_bg_max_is_shard_local(cpu_shards, interpret_mxu,
                                              monkeypatch):
    """VOC's production CRF (bi_sxy 40) at 104^2, 2 iterations: the grid
    route, so each of 2 shards runs the whole step on its 2 images.

    At this size the shard-local and the global bg max give the same
    labels, so the labels alone cannot tell them apart: the unaries the
    port's mesh run hands its CRF are held against the JAX probabilities
    of each shard's images (what the reference's fused step computes
    inside each shard), and shown to lie far from those of the whole
    batch (the global max)."""
    size = 104
    jseg, tseg = _voc_segmenters((1.5, 3, 40, 13, 10, 2), size)
    assert jseg._fused is not None
    mesh = make_mesh(2, ('data',), device='cpu')
    assert tseg.per_shard(mesh)
    imgs = _images(4, size)
    imgs[:2] //= 4                 # darker shard: another X_bg max
    seen = []
    real_mean_field = hsn.mean_field

    def recording_mean_field(probs, *args, **kwargs):
        seen.append(probs.numpy().copy())
        return real_mean_field(probs, *args, **kwargs)
    monkeypatch.setattr(hsn, 'mean_field', recording_mean_field)
    got = tseg.segment_batch(imgs, mesh=mesh).numpy()
    monkeypatch.setattr(hsn, 'mean_field', real_mean_field)
    unaries = np.concatenate(seen)
    shard_local = np.concatenate([np.asarray(jseg._probs_fn(imgs[:2])),
                                  np.asarray(jseg._probs_fn(imgs[2:]))])
    whole_batch = np.asarray(jseg._probs_fn(imgs))
    assert len(seen) == 2 and unaries.shape == shard_local.shape
    np.testing.assert_allclose(unaries, shard_local, atol=1e-4)
    # the inputs separate the two semantics by far more than that bound
    gap = np.abs(shard_local[..., 0] - whole_batch[..., 0]).max()
    assert gap > 1e-3, gap
    halves = np.concatenate([tseg.segment_batch(imgs[:2]).numpy(),
                             tseg.segment_batch(imgs[2:]).numpy()])
    np.testing.assert_array_equal(got, halves)
    want = np.asarray(jseg.segment_batch(
        imgs, mesh=jax_make_mesh(2, ('data',))))
    agree = (got == want).mean()
    whole = (got == tseg.segment_batch(imgs).numpy()).mean()
    print(f'against the JAX fused sharded step {agree:.6f}; against the '
          f'single-device run (global max) {whole:.6f}; bg channel of the '
          f'shard-local and the global max {gap:.4f} apart')
    assert agree >= LABEL_FLOOR, agree


def test_hsn_off_grid_bg_max_stays_global(cpu_shards):
    """VOC's M7 config (a small window) at 64^2: no grid, so the max is
    the batch's in both packages, and 3 images pad to 4 on 2 shards."""
    size = 64
    cfg = config.HSN_TEST[('VOC2012', 'M7')].astuple()[:5] + (2,)
    jseg, tseg = _voc_segmenters(cfg, size)
    assert jseg._fused is None
    mesh = make_mesh(2, ('data',), device='cpu')
    assert not tseg.per_shard(mesh)
    imgs = _images(3, size)
    got = tseg.segment_batch(imgs, mesh=mesh).numpy()
    assert got.shape == (3, size, size)
    single = tseg.segment_batch(imgs).numpy()
    assert (got == single).mean() >= 0.999
    want = np.asarray(jseg.segment_batch(
        imgs.astype(np.float32), mesh=jax_make_mesh(2, ('data',))))
    assert (got == want).mean() >= LABEL_FLOOR


def test_adp_hsn_on_a_mesh(cpu_shards):
    """ADPHSNSegmenter (M7 family, 31 classes) at 32^2, where the ADP CRFs
    take the dense kernel: 3 images on 2 shards."""
    size = 32
    jh, th = bridged_handles('M7', 31, size, seed=4)
    jseg = jax_hsn.ADPHSNSegmenter(jh, 'M7')
    tseg = hsn.ADPHSNSegmenter(th, 'M7', device='cpu')
    mesh = make_mesh(2, ('data',), device='cpu')
    imgs = _images(3, size, seed=5)
    gm, gf = (x.numpy() for x in tseg.segment_batch(imgs, mesh=mesh))
    sm, sf = (x.numpy() for x in tseg.segment_batch(imgs))
    wm, wf = (np.asarray(x) for x in jseg.segment_batch(
        imgs.astype(np.float32), mesh=jax_make_mesh(2, ('data',))))
    for got, single, want in ((gm, sm, wm), (gf, sf, wf)):
        assert got.shape == (3, size, size)
        assert (got == single).mean() >= 0.999
        assert (got == want).mean() >= LABEL_FLOOR
