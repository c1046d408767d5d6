"""The port's row-banded CRFs and 2-D sharded random walk against the JAX
package's on the same numpy inputs.

Meshes: the JAX side uses the conftest's 8 virtual CPU devices; the port
builds the same shapes of CPU shards (``Mesh([cpu] * n, ...)``).

Tolerances:
  * the windowed CRF (``ops/crf/sharded.py``): Q within 2e-4 of the JAX
    sharded run and of the single-device window, labels equal (the JAX
    test's bounds, tests/test_sharded_crf.py);
  * the banded grid (``ops/crf/mxu_sharded.py``): against the port's own
    single-device grid mean field, both float32, Q within 1e-5 and labels
    equal; against the JAX banded grid in interpret mode (bf16 kernels and
    Gaussian operands) atol 2.5e-2 and labels > 0.97, the JAX test's
    bounds (tests/test_mxu_sharded.py:44-49; measured 7.5e-3 and 0.996),
    and with ``ref_round=True`` within REF_ROUND_ATOL, labels >= 0.999;
  * the walk: rtol 2e-4, atol 2e-5 (the JAX test's).

The port takes the TPU's 8-aligned grid cells (``require8=True``), so the
grid cases run at bi_sxy 8 (t 8, halo 64) where the JAX test runs bi_sxy 3
in interpret mode: two shards need 128 rows, and h = 125 leaves 3 padded
rows that must send no message (the role of the JAX test's h = 45)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from test_torch_train_classifier import two_torch_threads  # noqa: F401
from wsss_tpu.ops import random_walk as jax_rw
from wsss_tpu.ops.crf import mxu_sharded as jax_mxu_sharded
from wsss_tpu.ops.crf import sharded as jax_sharded
from wsss_tpu.ops.crf.config import CRFConfig as JaxCRFConfig
from wsss_tpu_torch.ops import random_walk
from wsss_tpu_torch.ops.crf import meanfield, mxu_sharded, sharded
from wsss_tpu_torch.ops.crf.config import CRFConfig, hsn_config
from wsss_tpu_torch.parallel.mesh import Mesh

CPU = torch.device('cpu')
REF_ROUND_ATOL = 1e-5     # measured 3.6e-7, labels 1.0


def cpu_mesh(shape, names):
    devs = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        devs[idx] = CPU
    return Mesh(devs, names)


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _window_problem(h=128, w=32, c=4, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    img[: h // 2] = (50, 120, 200)
    img[h // 2:] = (200, 120, 50)
    img += rng.normal(0, 7, img.shape).astype(np.float32)
    img = np.clip(img, 0, 255)
    probs = rng.dirichlet(np.ones(c), (h, w)).astype(np.float32)
    return probs, img


WINDOW_CFG = (1.0, 2, 1.5, 30, 4, 3)


def _window_single_device(probs, img, cfg):
    """The single-device oracle of tests/test_sharded_crf.py: the direct
    window and the band-matrix Gaussian message."""
    p, i = torch.from_numpy(probs), torch.from_numpy(img)
    U = -torch.log(torch.clamp(p, min=1e-10))
    Q = torch.softmax(-U, -1)
    filt = meanfield.DirectBilateral(i, cfg.bi_sxy, cfg.bi_srgb)
    nb = torch.rsqrt(torch.clamp(filt.filter(torch.ones(p.shape[:2] + (1,))),
                                 min=1e-20))
    for _ in range(cfg.iterations):
        mb = nb * filt.filter(nb * Q) - nb * nb * Q
        mg = meanfield.gaussian_message(Q, cfg.g_sxy)
        Q = torch.softmax(-U + cfg.g_compat * mg + cfg.bi_compat * mb, -1)
    return Q.numpy()


@pytest.mark.parametrize('oracle', ['jax_sharded', 'single_device'])
def test_window_sharded_matches(oracle):
    probs, img = _window_problem()
    cfg = CRFConfig(*WINDOW_CFG)
    got = sharded.mean_field_sharded(torch.from_numpy(probs),
                                     torch.from_numpy(img), cfg,
                                     cpu_mesh((8,), ('data',))).numpy()
    if oracle == 'jax_sharded':
        want = np.asarray(jax_sharded.mean_field_sharded(
            jnp.asarray(probs), jnp.asarray(img), JaxCRFConfig(*WINDOW_CFG),
            jax_mesh((8,), ('data',))))
    else:
        want = _window_single_device(probs, img, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_window_shard_count_guard():
    probs, img = _window_problem(h=32)
    cfg = CRFConfig(g_sxy=2.0, g_compat=2, bi_sxy=4.0, bi_srgb=30,
                    bi_compat=4, iterations=1)
    # halo (2 * 12 = 24) > shard height (4) must be rejected loudly
    with pytest.raises(AssertionError, match='halo'):
        sharded.mean_field_sharded(torch.from_numpy(probs),
                                   torch.from_numpy(img), cfg,
                                   cpu_mesh((8,), ('data',)))


GRID_CFG = (1.0, 3, 8.0, 24, 10, 1)


def _grid_problem(h, w=24, c=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    probs = rng.dirichlet(np.ones(c), (h, w)).astype(np.float32)
    return probs, img


@pytest.mark.parametrize('h', [128, 125])
def test_grid_sharded_matches_single_device(h):
    probs, img = _grid_problem(h)
    cfg = CRFConfig(*GRID_CFG[:5], iterations=2)
    want = meanfield._mean_field_mxu(
        torch.from_numpy(probs)[None], torch.from_numpy(img)[None],
        g_sxy=cfg.g_sxy, g_compat=cfg.g_compat, bi_sxy=cfg.bi_sxy,
        bi_srgb=cfg.bi_srgb, bi_compat=cfg.bi_compat,
        iterations=cfg.iterations, cell_mult=1.0)[0].numpy()
    got = mxu_sharded.mean_field_sharded(
        torch.from_numpy(probs), torch.from_numpy(img), cfg,
        cpu_mesh((2,), ('data',))).numpy()
    assert got.shape == want.shape == (h, 24, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_grid_sharded_matches_jax_interpret():
    """h = 125 on two shards: the padded-rows case, once (the JAX banded
    grid in interpret mode takes tens of seconds on the CPU)."""
    probs, img = _grid_problem(125)
    want = np.asarray(jax_mxu_sharded.mean_field_sharded(
        jnp.asarray(probs), jnp.asarray(img), JaxCRFConfig(*GRID_CFG),
        jax_mesh((2,), ('data',)), interpret=True))
    for ref_round, atol, floor in ((False, 2.5e-2, 0.97),
                                   (True, REF_ROUND_ATOL, 0.999)):
        got = mxu_sharded.mean_field_sharded(
            torch.from_numpy(probs), torch.from_numpy(img),
            CRFConfig(*GRID_CFG), cpu_mesh((2,), ('data',)),
            ref_round=ref_round).numpy()
        err = float(np.abs(got - want).max())
        agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        print(f'ref_round={ref_round}: max |dQ| {err:.3g}, labels {agree}')
        assert got.shape == want.shape
        assert err <= atol, (ref_round, err)
        assert agree > floor, (ref_round, agree)


def test_grid_rejects_thin_bands():
    cfg = CRFConfig(1.0, 3, 8.0, 24, 10, iterations=1)
    with pytest.raises(ValueError, match='halo'):
        mxu_sharded.mean_field_sharded(torch.zeros(64, 32, 3),
                                       torch.zeros(64, 32, 3), cfg,
                                       cpu_mesh((8,), ('data',)))


def test_halo_at_deepglobe_production_geometry():
    cfg = hsn_config('DeepGlobe')
    t, halo = mxu_sharded._halo_px(cfg.bi_sxy)
    assert (t, halo) == (40, 320)
    assert (t, halo) == jax_mxu_sharded._halo_px(cfg.bi_sxy, require8=True)
    # 2448 rows on 8 shards: 320 owned rows each, exactly the halo
    hp = -(-2448 // (8 * t)) * (8 * t)
    assert hp // 8 == 320 >= halo


def _walk_problem(h, w, k=3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (k, h, w)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32))


def test_walk_sharded_matches_jax_and_single_device():
    cam, edge = _walk_problem(12, 12)
    kw = dict(beta=8.0, exp_times=3, radius=4)
    got = random_walk.propagate_to_edge_sharded(
        torch.from_numpy(cam), torch.from_numpy(edge),
        cpu_mesh((4, 2), ('data', 'model')), **kw).numpy()
    want_jax = np.asarray(jax_rw.propagate_to_edge_sharded(
        jnp.asarray(cam), jnp.asarray(edge),
        jax_mesh((4, 2), ('data', 'model')), **kw))
    single = random_walk.propagate_to_edge(
        torch.from_numpy(cam), torch.from_numpy(edge), **kw).numpy()
    np.testing.assert_allclose(got, want_jax, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, single, rtol=2e-4, atol=2e-5)


def test_walk_sharded_keeps_radius_unclamped():
    """On a grid under 9 px the unsharded walk clamps radius 5 to
    (min(h, w) + 1) // 2 = 4 and the sharded one does not, in both
    packages: the port's sharded walk equals the JAX sharded one and
    differs from its own unsharded walk."""
    cam, edge = _walk_problem(8, 12)
    kw = dict(beta=10.0, exp_times=2, radius=5)
    got = random_walk.propagate_to_edge_sharded(
        torch.from_numpy(cam), torch.from_numpy(edge),
        cpu_mesh((2, 1), ('data', 'model')), **kw).numpy()
    want = np.asarray(jax_rw.propagate_to_edge_sharded(
        jnp.asarray(cam), jnp.asarray(edge),
        jax_mesh((2, 1), ('data', 'model')), **kw))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    clamped = random_walk.propagate_to_edge(
        torch.from_numpy(cam), torch.from_numpy(edge), **kw).numpy()
    assert np.abs(got - clamped).max() > 1e-3
