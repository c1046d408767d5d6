"""Each configuration's FLOP count agrees with PyTorch's FlopCounterMode
on the program's networks at a small input, on the CPU."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import spec

BENCH = spec.load_benchmark()


def count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize('size', [33, 64])
def test_voc_vgg16_fgbg_forward(size):
    from wsss_tpu_torch.models.backbones import build_classifier
    cfg = {**spec.config(BENCH, 'voc_vgg16_fgbg'), 'input_size': size}
    x = torch.zeros(1, size, size, 3)
    total = 0
    for classes in cfg['networks'].values():
        net = build_classifier(cfg['model_tag'], classes,
                               dtype=torch.float32).eval()
        with torch.no_grad():
            total += count(lambda: net(x))
    macs = spec.flops('voc_vgg16_fgbg').forward_macs(cfg)
    assert total == 2 * macs['total']


@pytest.mark.parametrize('size', [33, 65])
def test_sec_voc_largefov_forward_and_train(size):
    from wsss_tpu_torch.models.deeplab import SECNet
    cfg = {**spec.config(BENCH, 'sec_voc_largefov'), 'input_size': size}
    net = SECNet(cfg['classes'])
    x = torch.zeros(2, size, size, 3)
    fl = spec.flops('sec_voc_largefov')
    with torch.no_grad():
        fwd = count(lambda: net.eval()(x))
    assert fwd == 2 * 2 * fl.forward_macs(cfg)['total']
    train = count(lambda: net.eval()(x).sum().backward())
    assert train == 2 * 2 * fl.train_macs(cfg)['total']
