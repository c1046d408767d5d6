"""The port's IRNet path index, affinities and random walk
(``wsss_tpu_torch/ops/random_walk.py``) against the JAX package's on the
same numpy inputs, and against brute-force numpy oracles.

Tolerances: the path geometry and both affinity forms are equal (a max
and a subtraction); the sliced form's gradient equals the gather form's
within 1e-6 in float64 (the two sum many paths into a pixel in another
order, which float32 rounds apart); the transition matrix within 1e-6;
the walk within 1e-5 of the output's max, or, at 8 squarings, within
twice the reference's own float32 error against a float64 walk.  Grids
stay at a few hundred nodes: the walk squares a dense [N, N] matrix."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wsss_tpu.ops import random_walk as jrw
from wsss_tpu_torch.ops import random_walk as rw


@pytest.mark.parametrize('radius,hw', [(3, (9, 11)), (5, (14, 17)),
                                       (10, (22, 25))])
def test_path_index_equals_jax(radius, hw):
    got, want = rw.PathIndex(radius), jrw.PathIndex(radius)
    assert got.radius_floor == want.radius_floor
    np.testing.assert_array_equal(got.search_dst, want.search_dst)
    np.testing.assert_array_equal(got.paths, want.paths)
    for a, b in zip(got.pair_indices(hw), want.pair_indices(hw)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.offset_membership(), want.offset_membership()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.path_gather_indices(hw),
                                  want.path_gather_indices(hw))


def test_path_index_geometry():
    p = rw.PathIndex(radius=5)
    d = p.search_dst
    assert np.all((d[:, 0] > 0) | ((d[:, 0] == 0) & (d[:, 1] > 0)))
    assert np.all((d ** 2).sum(1) < 25)
    assert len({(dy, dx) for dy, dx in d}) == len(d)
    for i, (dy, dx) in enumerate(d):
        assert (p.paths[i] == np.array([dy, dx])).all(1).any()
        assert (p.paths[i] == np.array([0, 0])).all(1).any()


@pytest.mark.parametrize('radius', [3, 5])
def test_affinities_equal_jax(radius):
    h, w, b = 12, 15, 2
    edge = np.random.default_rng(radius).random((b, h, w)).astype(np.float32)
    p, pj = rw.PathIndex(radius), jrw.PathIndex(radius)
    g = p.path_gather_indices((h, w))
    want = np.asarray(jrw.to_affinity(jnp.asarray(edge.reshape(b, -1)), g))
    got = rw.to_affinity(torch.from_numpy(edge.reshape(b, -1)), g).numpy()
    np.testing.assert_array_equal(got, want)
    want_s = np.asarray(jrw.to_affinity_sliced(jnp.asarray(edge), pj))
    got_s = rw.to_affinity_sliced(torch.from_numpy(edge), p).numpy()
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_s, got)


def test_to_affinity_sliced_matches_gather():
    """The sliced form equals the gather form in value and in gradient
    (the reference's tests/test_random_walk.py:89-116)."""
    h, w, b = 9, 11, 2
    p = rw.PathIndex(radius=4)
    g = p.path_gather_indices((h, w))
    rng = np.random.default_rng(3)
    edge2d = rng.random((b, h, w))
    wgt = torch.from_numpy(rng.random((b,) + g.shape[::2]))
    for dtype in (torch.float32, torch.float64):
        e = torch.tensor(edge2d, dtype=dtype)
        want = rw.to_affinity(e.reshape(b, -1), g)
        got = rw.to_affinity_sliced(e, p)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    grads = []
    for form in ('gather', 'sliced'):
        e = torch.tensor(edge2d, dtype=torch.float64, requires_grad=True)
        aff = (rw.to_affinity(e.reshape(b, -1), g) if form == 'gather'
               else rw.to_affinity_sliced(e, p))
        (aff * wgt).sum().backward()
        grads.append(e.grad)
    d = float((grads[0] - grads[1]).abs().max())
    print(f'sliced vs gather gradient: max |diff| {d:.3e} (float64)')
    assert d <= 1e-6


def _np_dense_affinity(edge, radius, beta):
    """Brute force: aff(i,j) = (1 - max edge on the discrete line)^beta."""
    h, w = edge.shape
    n = h * w
    p = rw.PathIndex(radius)
    mat = np.zeros((n, n), np.float64)
    rf = p.radius_floor
    for pi, (dy, dx) in enumerate(p.search_dst):
        for y in range(0, h - rf):
            for x in range(rf, w - rf):
                vals = [edge[y + py, x + px] for py, px in p.paths[pi]]
                i, j = y * w + x, (y + dy) * w + (x + dx)
                mat[i, j] += (1 - max(vals)) ** beta
    return mat + mat.T + np.eye(n)


def test_propagate_matches_bruteforce():
    rng = np.random.default_rng(0)
    h = w = 8
    edge = rng.random((h, w)).astype(np.float32) * 0.8
    cam = rng.random((3, h, w)).astype(np.float32)
    beta, exp_times, radius = 4.0, 2, 3
    mat = _np_dense_affinity(edge, radius, beta)
    trans = mat / mat.sum(0, keepdims=True)
    for _ in range(exp_times):
        trans = trans @ trans
    want = (cam.reshape(3, -1) @ trans).reshape(3, h, w)
    got = rw.propagate_to_edge(torch.from_numpy(cam), torch.from_numpy(edge),
                               beta=beta, exp_times=exp_times, radius=radius)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5)


def test_walk_respects_edges():
    """Mass does not cross a hard boundary."""
    h = w = 12
    edge = np.zeros((h, w), np.float32)
    edge[:, 5:7] = 1.0
    cam = np.zeros((1, h, w), np.float32)
    cam[0, :, :5] = 1.0
    out = rw.propagate_to_edge(torch.from_numpy(cam), torch.from_numpy(edge),
                               beta=8, exp_times=4, radius=4).numpy()
    assert out[0, :, 8:].max() < 1e-3
    assert out[0, :, :5].mean() > 0.1


@pytest.mark.parametrize('hw,radius,beta', [((12, 14), 5, 10.0),
                                            ((9, 16), 4, 4.0)])
def test_transition_matrix_equals_jax(hw, radius, beta):
    edge = np.random.default_rng(7).random(hw).astype(np.float32) * 0.9
    want = np.asarray(jrw._transition_matrix(jnp.asarray(edge), hw, beta,
                                             radius))
    got = rw._transition_matrix(torch.from_numpy(edge), hw, beta,
                                radius).numpy()
    d = np.abs(got - want).max()
    print(f'transition matrix {hw} radius {radius}: max |diff| {d:.3e}')
    assert d <= 1e-6
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)


def _np_walk(cam, edge, beta, exp_times, radius):
    """The walk in float64 numpy from the brute-force matrix."""
    mat = _np_dense_affinity(edge.astype(np.float64), radius, beta)
    trans = mat / mat.sum(0, keepdims=True)
    for _ in range(exp_times):
        trans = trans @ trans
    k = cam.shape[0]
    return (cam.reshape(k, -1).astype(np.float64) @ trans).reshape(cam.shape)


@pytest.mark.parametrize('exp_times', [1, 3, 8])
@pytest.mark.parametrize('hw', [(14, 18), (5, 7)])
def test_propagate_to_edge_equals_jax(exp_times, hw):
    """Within 1e-5 of the output's max of the JAX walk, or within twice
    the JAX walk's own float32 error against the exact (float64) walk
    where that is larger: 8 squarings (a 256-step walk) round 4e-5 to
    1.2e-4 of the max apart in either package.  (5, 7) takes the radius
    clamp: radius 5 becomes 3."""
    rng = np.random.default_rng(exp_times)
    edge = (rng.random(hw) * 0.9).astype(np.float32)
    edge[:, hw[1] // 2] = 0.95                     # a soft wall
    cam = rng.random((3,) + hw).astype(np.float32)
    want = np.asarray(jrw.propagate_to_edge(
        jnp.asarray(cam), jnp.asarray(edge), beta=10.0, exp_times=exp_times,
        radius=5))
    got = rw.propagate_to_edge(torch.from_numpy(cam), torch.from_numpy(edge),
                               beta=10.0, exp_times=exp_times,
                               radius=5).numpy()
    exact = _np_walk(cam, edge, 10.0, exp_times,
                     max(2, min(5, (min(hw) + 1) // 2)))
    scale = np.abs(exact).max()
    d = np.abs(got - want).max() / scale
    d_port, d_jax = (np.abs(x - exact).max() / scale for x in (got, want))
    print(f'walk {hw} exp_times {exp_times}, of the max: port vs JAX '
          f'{d:.3e}; against the float64 walk: port {d_port:.3e}, JAX '
          f'{d_jax:.3e}')
    assert d <= max(1e-5, 2 * d_jax)
    assert d_port <= max(1e-5, 2 * d_jax)
    if hw == (5, 7):
        clamped = rw.propagate_to_edge(
            torch.from_numpy(cam), torch.from_numpy(edge), beta=10.0,
            exp_times=exp_times, radius=3).numpy()
        np.testing.assert_array_equal(got, clamped)
