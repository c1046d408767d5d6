"""``adp_x17_hsn``'s counts, on the CPU: the X1.7 forward's FLOPs agree
with PyTorch's FlopCounterMode on the program's network, and the
windows' FLOPs with the multiply-adds the plain reference's offset loop
performs."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import spec
from benchmark.reference import adp_hsn
from benchmark.reference.numerics import Numerics

BENCH = spec.load_benchmark()
NAME = 'adp_x17_hsn'


@pytest.mark.parametrize('size', [33, 64])
def test_adp_x17_hsn_forward(size):
    from wsss_tpu_torch.models.backbones import build_classifier
    cfg = {**spec.config(BENCH, NAME), 'input_size': size}
    (classes,) = cfg['networks'].values()
    net = build_classifier(cfg['model_tag'], classes,
                           dtype=torch.float32).eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.zeros(1, size, size, 3))
    assert fc.get_total_flops() == 2 * spec.flops(NAME).forward_macs(
        cfg)['total']


def test_published_counts():
    cfg = spec.config(BENCH, NAME)
    fl = spec.flops(NAME)
    assert fl.forward_macs(cfg)['total'] == 9_335_157_504
    assert fl.window_offsets(10, 3.0) == 2821
    assert fl.window_flops(cfg) == 2821 * 224 ** 2 * (
        (2 + 5 * 2 * 29 + 11) + (2 + 5 * 2 * 5 + 11))


class ElementOps(TorchDispatchMode):
    """Elements written by multiplications and additions."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.mul.Tensor, torch.ops.aten.add.Tensor):
            self.count += out.numel()
        return out


def test_window_flops_count_the_reference_loop(monkeypatch):
    """Both CRFs of the reference at a small size: each window filter's
    products and sums, counted as they run, and 11 FLOPs for each weight
    map element the window builds, make ``window_flops``."""
    size, b = 14, 2
    crfs = {k: {**spec.config(BENCH, NAME)[k], 'bi_sxy': 2}
            for k in ('crf_morph', 'crf_func')}
    cfg = {**spec.config(BENCH, NAME), 'input_size': size, **crfs}
    counted = {'filters': 0, 'maps': 0}
    filt, init = adp_hsn.Window.filter, adp_hsn.Window.__init__

    def count_filter(self, x):
        with ElementOps() as ops:
            out = filt(self, x)
        counted['filters'] += ops.count
        return out

    def count_init(self, *a, **k):
        init(self, *a, **k)
        counted['maps'] += self.maps.numel()
    monkeypatch.setattr(adp_hsn.Window, 'filter', count_filter)
    monkeypatch.setattr(adp_hsn.Window, '__init__', count_init)
    rng = np.random.default_rng(0)
    imgs = torch.as_tensor(rng.uniform(0, 255, (b, size, size, 3)),
                           dtype=torch.float32)
    num = Numerics('fp32', 'cpu')
    for key, c in spec.flops(NAME).crf_channels(cfg).items():
        probs = torch.as_tensor(rng.uniform(0, 1, (b, size, size, c)),
                                dtype=torch.float32)
        adp_hsn.mean_field(num, probs, imgs, cfg[key],
                           cfg['window']['radius_sxy'])
    got = counted['filters'] + 11 * counted['maps']
    assert got == b * spec.flops(NAME).window_flops(cfg)
