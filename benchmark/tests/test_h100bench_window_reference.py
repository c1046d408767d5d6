"""The program's direct window (``meanfield.DirectBilateral.filter``)
against the plain reference's (``reference/adp_hsn.Window``), on the CPU:
equal within float32 rounding, on a ragged image smaller than the
window's radius and on one larger."""
import numpy as np
import pytest
import torch

from benchmark.reference import adp_hsn
from benchmark.reference.numerics import Numerics


@pytest.mark.parametrize('b,h,w,c,sxy,srgb', [
    (2, 5, 7, 3, 3.0, 40.0),        # smaller than the radius 9
    (1, 23, 31, 5, 3.0, 4.0),       # larger, ADP's colour sigma
])
def test_window_equals_the_reference(b, h, w, c, sxy, srgb):
    from wsss_tpu_torch.ops.crf.meanfield import DirectBilateral
    rng = np.random.default_rng(h * w)
    base = rng.uniform(0, 255, (b, 1, 1, 3))
    imgs = torch.as_tensor(base + rng.normal(0, 3.0, (b, h, w, 3)),
                           dtype=torch.float32).clamp(0, 255)
    x = torch.as_tensor(rng.uniform(0, 1, (b, h, w, c)),
                        dtype=torch.float32)
    prog = DirectBilateral(imgs, sxy, srgb)
    win = adp_hsn.Window(Numerics('fp32', 'cpu'), imgs, sxy, srgb, 3.0)
    assert len(win.offs) == len(prog.offs) == 253
    got, ref = prog.filter(x), win.filter(x)
    assert torch.allclose(got, ref, rtol=1e-5,
                          atol=1e-6 * float(ref.abs().max()))


def test_reversed_sum_stays_within_rounding():
    """The reference summed backwards: another order, the same sum."""
    rng = np.random.default_rng(3)
    imgs = torch.as_tensor(rng.uniform(0, 255, (1, 19, 17, 3)),
                           dtype=torch.float32)
    x = torch.as_tensor(rng.uniform(0, 1, (1, 19, 17, 4)),
                        dtype=torch.float32)
    num = Numerics('fp32', 'cpu')
    fwd = adp_hsn.Window(num, imgs, 2.0, 13.0, 3.0).filter(x)
    back = adp_hsn.Window(num, imgs, 2.0, 13.0, 3.0, reverse=True).filter(x)
    assert torch.allclose(fwd, back, rtol=1e-5)


def test_tf32_mode_rounds_the_window():
    """In the control's mode the window's operands are rounded to TF32
    on any device, so its result moves from the float32 one."""
    rng = np.random.default_rng(4)
    imgs = torch.as_tensor(rng.uniform(0, 255, (1, 12, 12, 3)),
                           dtype=torch.float32)
    x = torch.as_tensor(rng.uniform(0, 1, (1, 12, 12, 2)),
                        dtype=torch.float32)
    f32 = adp_hsn.Window(Numerics('fp32', 'cpu'), imgs, 2.0, 40.0,
                         3.0).filter(x)
    t32 = adp_hsn.Window(Numerics('tf32', 'cpu'), imgs, 2.0, 40.0,
                         3.0).filter(x)
    gap = float((f32 - t32).abs().max() / f32.abs().max())
    assert 1e-5 < gap < 1e-2
