"""The direct window's kernel (``kernels/bilateral.py:direct_window``,
``csrc/direct_window.cu``) and ``meanfield.DirectBilateral`` around it.

On the CPU: the planner at ADP's, VOC M7's and a ragged small guide's
shapes; the kernel's walk (blocks, steps, runs of dx, the warp's clip)
replayed in Python, which must visit each pixel's offsets inside the
image once each, in the table's order, and sum to the plain version; the
table built from ``offs`` and ``wspace`` at the first filter, so that a
window cut after ``__init__`` is the window filtered; the cached offset
enumeration, the span and ``WINDOW_OFFSETS``.

On a card (marked ``cuda``, skipped without one): the kernel against the
plain version (``K.plain_versions()``) at ADP's and VOC M7's shapes, on
a guide smaller than the radius and an odd width; an image alone equal
bit for bit to the same image in a batch; one launch a filter; a type or
shape the kernel does not take raises, with no fallback.  This
file imports no jax:
    python -m pytest --noconftest tests/test_torch_direct_window.py -m cuda
"""
import math

import numpy as np
import pytest
import torch

from wsss_tpu_torch.kernels import bilateral as K
from wsss_tpu_torch.ops.crf import meanfield as mf


def _table(sxy):
    _, offs, ws = mf._window_offsets(float(sxy))
    return K.WindowTable(offs, ws)


def _offsets(table):
    """The table's offsets in the kernel's order (dy, then dx)."""
    return [(table.dy0 + k, dx) for k, (lo, hi) in enumerate(table.rows)
            for dx in range(lo, hi + 1)]


def _weight(table, dy, dx):
    """The table's spatial weight of (dy, dx): 0 off the window."""
    nk = table.ndy + 2 * K._WINDOW_PAD
    return table.dense[(dx + table.rx) * nk + dy - table.dy0
                       + K._WINDOW_PAD]


def _groups(plan, c):
    """(first channel, channels) of each of the plan's channel groups."""
    return [(c0, min(plan.g, c - c0)) for c0 in range(0, c, plan.g)]


def _guides(b, h, w, seed, noise=3.0):
    """Flat-coloured 4-px blocks plus noise: neighbours close in colour,
    so ADP's srgb 4 weights are not all ~0."""
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(40, 250, (b, -(-h // 4), -(-w // 4), 3))
    img = np.repeat(np.repeat(blocks, 4, 1), 4, 2)[:, :h, :w]
    img = img + rng.normal(0, noise, img.shape)
    return torch.as_tensor(np.clip(img, 0, 255), dtype=torch.float32)


def _x(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0, 1, (b, h, w, c)),
                           dtype=torch.float32)


def _by_table(img, x, table, srgb):
    """The window the table describes, offset by offset in float64."""
    img, x = img.double(), x.double()
    out = torch.zeros_like(x)
    for dy, dx in _offsets(table):
        d2 = ((img - mf._shift2d(img, dy, dx)) ** 2).sum(-1, keepdim=True)
        out += _weight(table, dy, dx) * \
            torch.exp(-0.5 * d2 / (srgb * srgb)) * mf._shift2d(x, dy, dx)
    return out.float()


# --- the planner -----------------------------------------------------------

PLAN_CASES = [  # (B, H, W, C, sxy): ADP's three widths, VOC M7, ragged ones
    (8, 224, 224, 29, 10), (8, 224, 224, 5, 10), (8, 224, 224, 1, 10),
    (8, 224, 224, 21, 5 / 3), (8, 321, 321, 29, 10), (2, 5, 7, 3, 3.0),
    (1, 9, 70, 40, 1.0), (3, 33, 37, 64, 2.0)]


@pytest.mark.parametrize('b,h,w,c,sxy', PLAN_CASES)
def test_plan_fits_a_block_and_covers_the_image(b, h, w, c, sxy):
    table = _table(sxy)
    plan = K.direct_window_plan(b, h, w, c, table.rx)
    assert plan.g in K._WINDOW_G and plan.groups == -(-c // 32)
    assert plan.g >= -(-c // plan.groups)
    groups = _groups(plan, c)
    assert [c0 for c0, _ in groups] == list(range(0, c, plan.g))
    assert sum(n for _, n in groups) == c and min(n for _, n in groups) >= 1
    assert plan.p == K._window_rows(plan.g) and 1 <= plan.p <= 8
    slot = (32 + 2 * table.rx) * (4 + (plan.g | 1))
    assert plan.smem_bytes == 2 * 4 * (-(-slot // 4) * 4) <= K.SMEM_BLOCK
    gx, gy, gz = plan.grid
    assert (gx - 1) * 32 < w <= gx * 32
    assert (gy - 1) * plan.p < h <= gy * plan.p
    assert gz == b * plan.groups


def test_plan_by_shape():
    """One path, sized by what it observes: ADP's morph width takes the
    fewest rows a thread, its normalizer the most; channels past 32 go
    in even groups; a bad shape raises."""
    adp = _table(10)
    assert (adp.rx, adp.ndy, len(_offsets(adp))) == (30, 61, 2821)
    p29 = K.direct_window_plan(8, 224, 224, 29, adp.rx)
    p1 = K.direct_window_plan(8, 224, 224, 1, adp.rx)
    assert (p29.g, p29.p) == (29, 4) and (p1.g, p1.p) == (1, 8)
    assert K.direct_window_plan(8, 224, 224, 21, 5).p == 6
    p40 = K.direct_window_plan(1, 224, 224, 40, adp.rx)
    assert _groups(p40, 40) == [(0, 21), (21, 19)]
    p33 = K.direct_window_plan(1, 224, 224, 33, adp.rx)
    assert (p33.groups, _groups(p33, 33)) == (2, [(0, 21), (21, 12)])
    assert [K.direct_window_plan(1, 9, 9, c, 3).g
            for c in (1, 3, 5, 6, 21, 22, 29, 30)] == [1, 4, 5, 8, 21, 29,
                                                       29, 32]
    with pytest.raises(ValueError, match='non-empty'):
        K.direct_window_plan(1, 0, 224, 5, adp.rx)
    with pytest.raises(ValueError, match='no block'):
        K.direct_window_plan(1, 224, 224, 32, 3000)


# --- the kernel's walk, replayed --------------------------------------------

def _walk(plan, table, b, h, w):
    """The offsets the kernel adds to each stored pixel (b, y, x), in its
    order: warps of p rows x 32 columns, steps over the rows the window
    reaches (rows outside the image skipped), the union of the pixels'
    runs of dx clipped to columns some lane has inside, each pair
    weighted by the dense table (0 off the window)."""
    visits = {}
    for bz in range(plan.grid[2]):
        if bz % plan.groups:
            continue            # every channel group walks alike
        bi = bz // plan.groups
        for by in range(plan.grid[1]):
            y0 = by * plan.p
            for bx in range(plan.grid[0]):
                x0 = bx * 32
                for t in range(table.ndy + plan.p - 1):
                    r = y0 + table.dy0 + t
                    if not 0 <= r < h:
                        continue
                    runs = [table.rows[t - j] for j in range(plan.p)
                            if 0 <= t - j < table.ndy and y0 + j < h]
                    runs = [(lo, hi) for lo, hi in runs if lo <= hi]
                    if not runs:
                        continue
                    dlo = max(min(lo for lo, _ in runs), -(x0 + 31))
                    dhi = min(max(hi for _, hi in runs), w - 1 - x0)
                    for dx in range(dlo, dhi + 1):
                        for j in range(plan.p):
                            ws = _weight(table, table.dy0 + t - j, dx)
                            if not ws or y0 + j >= h:   # or not stored
                                continue
                            for xl in range(x0, min(x0 + 32, w)):
                                visits.setdefault((bi, y0 + j, xl), []
                                                  ).append((r - y0 - j, dx))
    return visits


WALK_CASES = [  # (B, H, W, C, sxy): a guide inside the radius, column
    (2, 5, 7, 3, 3.0),          # tiles and two channel groups, a ragged
    (1, 9, 70, 40, 1.0), (1, 11, 75, 2, 1.7)]      # window


@pytest.mark.parametrize('b,h,w,c,sxy', WALK_CASES)
def test_walk_visits_each_offset_once_in_order(b, h, w, c, sxy):
    table = _table(sxy)
    plan = K.direct_window_plan(b, h, w, c, table.rx)
    visits = _walk(plan, table, b, h, w)
    assert set(visits) == {(bi, y, xx) for bi in range(b)
                           for y in range(h) for xx in range(w)}
    img, x = _guides(b, h, w, seed=h), _x(b, h, w, c, seed=w)
    want = mf.DirectBilateral(img, sxy, 13.0)._filter(x)
    inv = 0.5 / 13.0 ** 2
    got = torch.zeros_like(x, dtype=torch.float64)
    for (bi, y, xx), offs in visits.items():
        # columns outside the image add w * 0; rows outside are skipped
        assert all(0 <= y + dy < h for dy, _ in offs)
        inside = [(dy, dx) for dy, dx in offs if 0 <= xx + dx < w]
        assert inside == [(dy, dx) for dy, dx in _offsets(table)
                          if 0 <= y + dy < h and 0 <= xx + dx < w]
        for dy, dx in inside:
            d2 = float(((img[bi, y, xx] - img[bi, y + dy, xx + dx]) ** 2)
                       .sum())
            got[bi, y, xx] += _weight(table, dy, dx) * math.exp(-d2 * inv) * \
                x[bi, y + dy, xx + dx].double()
    assert torch.allclose(got.float(), want, rtol=1e-5,
                          atol=1e-6 * float(want.abs().max()))


# --- the table, the enumeration, the span and the counter -------------------

def test_table_rows_and_refusals():
    t = K.WindowTable([(-2, 0), (0, -1), (0, 0), (0, 1), (1, 0)],
                      [1, 2, 3, 4, 5])
    assert (t.dy0, t.ndy, t.rx) == (-2, 4, 1)
    assert t.rows == ((0, 0), (1, 0), (-1, 1), (0, 0))
    assert _offsets(t) == [(-2, 0), (0, -1), (0, 0), (0, 1), (1, 0)]
    dense = np.array(t.dense).reshape(3, 4 + 14)[:, 7:11]
    np.testing.assert_array_equal(dense, [[0, 0, 2, 0], [1, 0, 3, 5],
                                          [0, 0, 4, 0]])
    assert sum(t.dense) == 15
    with pytest.raises(ValueError, match='does not extend'):
        K.WindowTable([(0, 0), (0, 2)], [1, 1])
    with pytest.raises(ValueError, match='out of dy order'):
        K.WindowTable([(1, 0), (0, 0)], [1, 1])
    with pytest.raises(ValueError, match='spatial weights'):
        K.WindowTable([(0, 0)], [1, 1])


@pytest.mark.parametrize('sxy', [1.0, 1.7, 5 / 3, 3.0, 10.0])
def test_cached_enumeration_gives_the_lists_as_before(sxy):
    """The enumeration ``__init__`` ran at every call, now cached by sxy;
    each instance still owns its lists."""
    r = int(np.ceil(3.0 * sxy))
    offs, wspace = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d2 = dy * dy + dx * dx
            if d2 > (3.0 * sxy) ** 2:
                continue
            offs.append((dy, dx))
            wspace.append(float(np.exp(-0.5 * d2 / (sxy * sxy))))
    img = torch.zeros((4, 4, 3))
    a, b = mf.DirectBilateral(img, sxy, 13), mf.DirectBilateral(img, sxy, 13)
    assert a.r == r and a.offs == offs and a.wspace == wspace
    assert _offsets(K.WindowTable(a.offs, a.wspace)) == offs
    a.offs.pop()
    a.wspace.pop()
    assert b.offs == offs and b.wspace == wspace
    assert mf.DirectBilateral(img, sxy, 13).offs == offs


def _cut(win, radius):
    keep = [i for i, (dy, dx) in enumerate(win.offs)
            if dy * dy + dx * dx <= radius * radius]
    win.offs = [win.offs[i] for i in keep]
    win.wspace = [win.wspace[i] for i in keep]


def test_a_cut_after_init_is_the_window_filtered(monkeypatch):
    """The kernel's table comes from ``offs`` and ``wspace`` at the
    first filter (the kernel replaced by the table's window in float64,
    as if on a card), so a cut made after ``__init__`` is what both the
    kernel's route and the plain version filter."""
    img, x = _guides(2, 12, 13, seed=5), _x(2, 12, 13, 3, seed=6)
    sxy, srgb = 2.0, 13.0
    full = mf.DirectBilateral(img, sxy, srgb).filter(x)
    plain = mf.DirectBilateral(img, sxy, srgb)
    _cut(plain, 3)
    cut = plain.filter(x)
    assert float((cut - full).abs().max()) > 1e-2 * float(full.abs().max())

    tables = []

    def by_table(img_, x_, table, srgb_):
        tables.append(table)
        return _by_table(img_, x_, table, srgb_)
    monkeypatch.setattr(K, '_use_kernel', lambda *t: True)
    monkeypatch.setattr(K, 'direct_window', by_table)
    win = mf.DirectBilateral(img, sxy, srgb)
    _cut(win, 3)
    got = win.filter(x)
    again = win.filter(x)
    assert tables[0] is tables[1]
    assert _offsets(tables[0]) == win.offs
    assert [_weight(tables[0], *o) for o in win.offs] == win.wspace
    assert torch.equal(got, again)
    assert torch.allclose(got, cut, rtol=1e-5,
                          atol=1e-6 * float(cut.abs().max()))


def test_filter_span_counter_and_cpu_route(monkeypatch):
    """Each filter opens ``wsss.window.filter`` and adds the window's
    offsets to ``WINDOW_OFFSETS``, for a batch and for one guide; CPU
    tensors take the plain version (no launch) and the kernel's wrapper
    refuses them."""
    names = []
    real = mf.span

    def recording(name):
        names.append(name)
        return real(name)
    monkeypatch.setattr(mf, 'span', recording)
    img, x = _guides(2, 6, 9, seed=1), _x(2, 6, 9, 2, seed=2)
    win = mf.DirectBilateral(img, 1.0, 20.0)
    one = mf.DirectBilateral(img[1], 1.0, 20.0)
    before, launches = mf.WINDOW_OFFSETS, dict(K.LAUNCHES)
    out = win.filter(x)
    assert torch.equal(one.filter(x[1]), out[1])
    assert names == ['wsss.window.filter'] * 2
    assert mf.WINDOW_OFFSETS - before == 2 * len(win.offs) == 2 * 29
    assert K.LAUNCHES == launches
    with pytest.raises(ValueError, match='CUDA tensors only'):
        K.direct_window(img, x, K.WindowTable(win.offs, win.wspace), 20.0)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the direct window is CUDA C++ with '
                    'no CPU mode')
    return torch.device('cuda')


def _kernel_and_plain(img, x, sxy, srgb):
    win = mf.DirectBilateral(img, sxy, srgb)
    got = win.filter(x)
    with K.plain_versions():
        want = win.filter(x)
    return got, want


CARD_CASES = [  # (B, H, W, C, sxy, srgb)
    (2, 224, 224, 1, 10, 40), (2, 224, 224, 5, 10, 4),
    (2, 224, 224, 29, 10, 40), (2, 224, 224, 29, 10, 4),
    (8, 224, 224, 21, 80 / 48, 13),
    (2, 5, 7, 3, 10, 40),       # inside the radius
    (3, 37, 53, 40, 1.7, 13)]   # odd width, two channel groups


@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w,c,sxy,srgb', CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, b, h, w, c, sxy, srgb):
    img = _guides(b, h, w, seed=h * w).to(cuda_device)
    x = _x(b, h, w, c, seed=c).to(cuda_device)
    got, want = _kernel_and_plain(img, x, sxy, srgb)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert torch.isfinite(got).all() and err <= 1e-5, err


@pytest.mark.cuda
def test_image_alone_equals_it_in_a_batch(cuda_device):
    """An image's bits depend on its own image alone: the same at batch
    8 as alone (whose plan differs), at each of ADP's widths."""
    img = _guides(8, 224, 224, seed=3).to(cuda_device)
    for c, srgb in ((1, 4), (5, 4), (29, 40)):
        x = _x(8, 224, 224, c, seed=c).to(cuda_device)
        batch = mf.DirectBilateral(img, 10, srgb).filter(x)
        alone = mf.DirectBilateral(img[5], 10, srgb).filter(x[5])
        assert torch.equal(batch[5], alone), c


@pytest.mark.cuda
def test_one_launch_a_filter(cuda_device):
    """A mean field on the window: one ``direct_window`` launch for the
    normalizer and one an iteration, and no other hand kernel."""
    from wsss_tpu_torch.ops.crf import config
    cfg = config.hsn_config('ADP-func')
    assert mf.bilateral_structure((112, 112), cfg.bi_sxy, cfg.bi_srgb) == \
        'direct'
    img = _guides(2, 112, 112, seed=4).to(cuda_device)
    probs = torch.softmax(_x(2, 112, 112, 5, seed=5) * 4, -1)
    probs = probs.to(cuda_device)
    K.reset_launch_counts()
    q = mf.mean_field(probs, img, cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(q).all()
    assert K.LAUNCHES == dict({k: 0 for k in K.LAUNCHES},
                              direct_window=cfg.iterations + 1)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    img = _guides(1, 8, 8, seed=6).to(cuda_device)
    x = _x(1, 8, 8, 3, seed=7).to(cuda_device)
    win = mf.DirectBilateral(img, 1.0, 13.0)
    before = dict(K.LAUNCHES)
    with pytest.raises(TypeError, match='float32'):
        win.filter(x.double())
    with pytest.raises(ValueError, match='contiguous'):
        win.filter(x.transpose(1, 2))
    with pytest.raises(ValueError, match='guide'):
        win.filter(x[:, :, :7].contiguous())
    assert K.LAUNCHES == before


@pytest.mark.cuda
def test_strided_guide_is_taken(cuda_device):
    """A guide that is a strided view (an NCHW tensor permuted to NHWC)
    filters as its contiguous copy: the window copies it once."""
    img = _guides(2, 24, 20, seed=8).to(cuda_device)
    nchw = img.permute(0, 3, 1, 2).contiguous()
    x = _x(2, 24, 20, 5, seed=9).to(cuda_device)
    view = mf.DirectBilateral(nchw.permute(0, 2, 3, 1), 2.0, 13.0)
    assert torch.equal(view.filter(x),
                       mf.DirectBilateral(img, 2.0, 13.0).filter(x))
