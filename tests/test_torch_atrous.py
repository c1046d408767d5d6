"""fc6's explicit product (``models/deeplab.py:atrous_conv``) against
``F.conv2d``: on the CPU the forward within float32 rounding at every
head's rate, on maps smaller than the rate and in both memory layouts,
on the card the same bits; the gradients the convolution's bits; an
image the same bits alone and in a batch; the count of calls and the
``wsss.net.atrous`` span.  No JAX: the card's cases run with
``--noconftest -m cuda``."""
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from wsss_tpu_torch.models import deeplab
from wsss_tpu_torch.utils import timing

SEC_RATE, DSRG_RATES = 12, (6, 12, 18, 24)


def _conv(rate, in_ch=512, out_ch=1024, seed=0):
    torch.manual_seed(seed)
    conv = nn.Conv2d(in_ch, out_ch, 3, padding=rate, dilation=rate)
    with torch.no_grad():
        conv.bias.normal_(0, 0.05)
    return conv


def _input(shape, channels_last, seed=1, device='cpu'):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=g, device=device))
    return x.contiguous(memory_format=torch.channels_last
                        if channels_last else torch.contiguous_format)


def _close(got, want):
    """Within float32 rounding of a 4 608-term sum: 1e-5 of the largest
    magnitude."""
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


# (batch, channels, H, W): 41^2 is fc6's map at 321^2; 9^2 and 5x7 lie
# inside the rate, so every off-centre tap reads only the padding
SHAPES = [(1, 512, 9, 9), (4, 512, 9, 9), (4, 512, 5, 7), (1, 512, 17, 13),
          (4, 64, 41, 41)]


@pytest.mark.parametrize('channels_last', [False, True])
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('rate', sorted({SEC_RATE, *DSRG_RATES}))
def test_forward_matches_conv2d(rate, shape, channels_last):
    conv = _conv(rate, in_ch=shape[1])
    x = _input(shape, channels_last)
    with torch.no_grad():
        got = deeplab.atrous_conv(x, conv)
        want = F.conv2d(x, conv.weight, conv.bias, padding=rate,
                        dilation=rate)
        exact = F.conv2d(x.double(), conv.weight.double(),
                         conv.bias.double(), padding=rate, dilation=rate)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got, want)
    _close(got.double(), exact)


@pytest.mark.parametrize('channels_last', [False, True])
@pytest.mark.parametrize('rate', [SEC_RATE, 24])
def test_gradients_are_the_convolutions(rate, channels_last):
    """Given one upstream gradient, the input, weight and bias gradients
    are the bits ``F.conv2d``'s backward gives."""
    conv = _conv(rate)
    x = _input((2, 512, 9, 11), channels_last).requires_grad_()
    up = torch.randn(2, 1024, 9, 11, generator=torch.Generator()
                     .manual_seed(2))
    args = (x, conv.weight, conv.bias)
    got = torch.autograd.grad(deeplab.atrous_conv(x, conv), args, up)
    want = torch.autograd.grad(
        F.conv2d(x, conv.weight, conv.bias, padding=rate, dilation=rate),
        args, up)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('channels_last', [False, True])
@pytest.mark.parametrize('shape', [(4, 512, 9, 9), (4, 512, 17, 13)])
def test_an_image_alone_equals_it_in_a_batch(shape, channels_last):
    conv = _conv(SEC_RATE, in_ch=shape[1])
    x = _input(shape, channels_last)
    with torch.no_grad():
        batch = deeplab.atrous_conv(x, conv)
        for i in range(shape[0]):
            alone = deeplab.atrous_conv(x[i:i + 1], conv)
            assert torch.equal(alone[0], batch[i])


def _net(method):
    torch.manual_seed(0)
    return (deeplab.SECNet(5) if method == 'SEC' else deeplab.DSRGNet(5))


@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_fc6_keeps_its_module_and_names(method):
    net = _net(method)
    heads = [net.head] if method == 'SEC' else list(net.branches)
    for head, rate in zip(heads, [SEC_RATE] if method == 'SEC'
                          else DSRG_RATES):
        assert type(head.fc6) is nn.Conv2d
        assert head.fc6.dilation == (rate, rate)
        assert head.fc6.padding == (rate, rate)
    keys = [k for k in net.state_dict() if '.fc6.' in k]
    want = (['head.fc6.weight', 'head.fc6.bias'] if method == 'SEC' else
            [f'branches.{i}.fc6.{p}' for i in range(4)
             for p in ('weight', 'bias')])
    assert keys == want


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('method', ['SEC', 'DSRG'])
def test_network_matches_fc6_as_conv2d(method, train, monkeypatch):
    """Whole networks, in eval and in train mode (same dropout draws):
    logits within float32 rounding of the networks with fc6 run as
    ``F.conv2d``, and so are the parameters' gradients."""
    net = _net(method).train(train)
    x = torch.randn(2, 33, 41, 3, generator=torch.Generator()
                    .manual_seed(3)) * 50

    def run():
        net.zero_grad()
        out = net(x, torch.Generator().manual_seed(4))
        out.square().sum().backward()
        return out.detach(), [p.grad.clone() for p in net.parameters()]
    got, got_g = run()
    monkeypatch.setattr(deeplab, 'atrous_conv', lambda x, conv: conv(x))
    want, want_g = run()
    _close(got, want)
    for g, w in zip(got_g, want_g):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize('method,calls', [('SEC', 1), ('DSRG', 4)])
def test_count_and_span_of_the_product(method, calls):
    net = _net(method).eval()
    x = torch.randn(1, 33, 33, 3)
    before = deeplab.ATROUS_CALLS
    with torch.no_grad():
        net(x)
    assert deeplab.ATROUS_CALLS == before + calls
    assert 'wsss.net.atrous' in timing.SPANS
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu) as prof, torch.no_grad():
        net(x)
    named = [e for e in prof.events() if e.name == 'wsss.net.atrous']
    assert len(named) == calls
    assert deeplab.ATROUS_CALLS == before + 2 * calls


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(8, 512, 41, 41), (1, 512, 47, 63)])
def test_fc6_on_the_card_equals_conv2d(shape):
    """fc6 at rate 12 on the card, TF32 off: at 321^2, batch 8 (cuDNN's
    direct kernel) and at a 375x500 image's map (its implicit GEMM) the
    same bits as ``F.conv2d``; an image the same bits alone; the weight
    and bias gradients the convolution's bits, the input gradient within
    rounding (cuDNN's input gradient is not bit-reproducible itself)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from wsss_tpu_torch.utils.device import resolve_device
    dev = resolve_device('cuda')
    conv = _conv(SEC_RATE).to(dev)
    x = _input(shape, True, device=dev).requires_grad_()
    got = deeplab.atrous_conv(x, conv)
    want = F.conv2d(x, conv.weight, conv.bias, padding=SEC_RATE,
                    dilation=SEC_RATE)
    assert torch.equal(got, want)
    with torch.no_grad():
        i = shape[0] - 1
        assert torch.equal(deeplab.atrous_conv(x[i:i + 1], conv)[0], got[i])
    up = torch.randn(got.shape, generator=torch.Generator(dev)
                     .manual_seed(2), device=dev)
    args = (x, conv.weight, conv.bias)
    (gx, gw, gb), (wx, ww, wb) = (torch.autograd.grad(y, args, up)
                                  for y in (got, want))
    assert torch.equal(gw, ww) and torch.equal(gb, wb)
    _close(gx, wx)
