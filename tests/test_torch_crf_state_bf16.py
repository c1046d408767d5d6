"""The reference's bf16 mean-field state in the port's ``mean_field``.

The reference keeps the grid path's loop state in bf16
(``_CRF_STATE_BF16``, wsss_tpu/ops/crf/meanfield.py:58) except in
interpret mode, which always runs float32 (:602): the JAX package cannot
run the bf16 loop on the CPU, so there is nothing to hold it to here.
What these tests pin on the port's side: the flag defaults to off,
``mean_field`` passes it to the grid path on a CUDA device only, so on
the CPU it changes nothing, bit for bit; and the bf16 loop itself, run
on the CPU by a direct call, stays within bf16 rounding of the float32
loop.  Its bounds are set from the observed error (mean |dQ| 1.72e-3 and
1.78e-3, argmax agreement 0.99698 and 0.99639 at the two seeds): a loop
that drops either message, or rounds one to 4 mantissa bits, fails them.
On the card ``chip_smoke.py``'s precision phase holds the bf16 loop to
the float32 one at the main path's shapes."""
import numpy as np
import pytest
import torch

from wsss_tpu_torch.ops.crf import config
from wsss_tpu_torch.ops.crf import meanfield as mf

CFG = config.CRFConfig(1.5, 3, 40.0, 13.0, 10.0, 2)


def _problem(seed=0, hw=(112, 104), c=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2,) + hw + (c,)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    imgs = rng.uniform(0, 255, (2,) + hw + (3,)).astype(np.float32)
    return torch.from_numpy(probs), torch.from_numpy(imgs)


def test_flag_defaults_off():
    assert mf._CRF_STATE_BF16 is False


@pytest.mark.parametrize('flag', [False, True])
def test_mean_field_keeps_f32_state_on_the_cpu(monkeypatch, flag):
    seen = []

    def spy(probs, imgs, **kw):
        seen.append(kw['state_bf16'])
        return probs
    monkeypatch.setattr(mf, '_mean_field_mxu', spy)
    monkeypatch.setattr(mf, '_CRF_STATE_BF16', flag)
    probs, imgs = _problem()
    assert mf._mxu_ok(tuple(probs.shape[1:3]), probs.shape[-1], CFG)
    mf.mean_field(probs, imgs, CFG)
    assert seen == [False]


@pytest.fixture
def one_thread():
    """Bit for bit needs one thread: with several, the CPU's matrix
    products may split their sums differently from call to call."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_flag_is_a_no_op_on_the_cpu(monkeypatch, one_thread):
    probs, imgs = _problem(1)
    want = mf.mean_field(probs, imgs, CFG)
    monkeypatch.setattr(mf, '_CRF_STATE_BF16', True)
    got = mf.mean_field(probs, imgs, CFG)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize('seed', [1, 2])
def test_bf16_state_loop_within_rounding_of_f32(seed):
    """Both messages at full resolution (the CPU has no bf16 antialiased
    resize, so the downsampled message is the card's to check), ten
    iterations."""
    cfg = config.CRFConfig(3, 3, 80.0, 13.0, 10.0, 10)
    probs, imgs = _problem(seed, hw=(96, 88))
    kw = dict(g_sxy=cfg.g_sxy, g_compat=cfg.g_compat, bi_sxy=cfg.bi_sxy,
              bi_srgb=cfg.bi_srgb, bi_compat=cfg.bi_compat,
              iterations=cfg.iterations)
    want = mf._mean_field_mxu(probs, imgs, **kw)
    got = mf._mean_field_mxu(probs, imgs, **kw, state_bf16=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    dq = float((got - want).abs().mean())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    assert 0 < dq <= 2.4e-3, dq
    assert agree >= 0.99, agree


def test_gaussian_message_operands_in_bf16():
    """dtype=bf16 casts the band matrices and x, and returns x's dtype,
    within bf16 rounding of the float32 product."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 24, 20, 3)).astype(np.float32))
    want = mf._gaussian_filter_raw(x, 3.0)
    got = mf._gaussian_filter_raw(x, 3.0, dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    err = float((got - want).abs().max() / want.abs().max())
    assert 0 < err <= 2e-2
    xb = x.to(torch.bfloat16)
    assert mf._gaussian_filter_raw(xb, 3.0, dtype=torch.bfloat16).dtype \
        == torch.bfloat16
