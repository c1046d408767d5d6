"""The port's Grad-CAM weights, confidence CAM and HistoSegNet VOC probs
against the JAX package, on the same bridged weights and numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import perturbed_variables
from wsss_tpu.data import registry as jax_registry
from wsss_tpu.methods import hsn as jax_hsn
from wsss_tpu.methods.gradcam_cues import _ClassifierHandle as JaxHandle
from wsss_tpu.ops import gradcam as jax_gc
from wsss_tpu.ops.crf.config import CRFConfig as JaxCRFConfig
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
from wsss_tpu_torch.ops import gradcam as gc
from wsss_tpu_torch.ops.crf.config import CRFConfig


def bridged_handles(model_type, num_classes, size, seed):
    """(JAX handle, port handle on the CPU) sharing perturbed weights."""
    model, variables = perturbed_variables(model_type, num_classes, size,
                                           seed)
    th = np.full(num_classes, 0.5, np.float32)
    jh = JaxHandle(model, jax.tree_util.tree_map(jnp.asarray, variables),
                   th, size)
    return jh, _ClassifierHandle.from_flax(model_type, variables, th, size,
                                           device='cpu')


@pytest.mark.parametrize('model_type,size', [('VGG16', 64),   # GAP head
                                             ('M7', 48)])     # max head
def test_gradcam_weights_match_jax(model_type, size):
    jh, th = bridged_handles(model_type, 6, size, seed=7)
    want = np.asarray(jh.weights)
    got = th.weights.numpy()
    assert got.shape == want.shape
    # f32 through a different conv stack: 1e-4 of the largest weight
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_grad_cam_confidence_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 1, (3, 7, 7, 16)).astype(np.float32)
    weights = rng.normal(0, 1, (16, 5)).astype(np.float32)
    scores = rng.uniform(0, 1, (3, 5)).astype(np.float32)
    is_pass = scores >= 1 / 3
    want = np.asarray(jax_gc.grad_cam_confidence(
        feats, weights, is_pass, scores, upsample_hw=(30, 30)))
    got = gc.grad_cam_confidence(
        torch.from_numpy(feats), torch.from_numpy(weights),
        torch.from_numpy(is_pass), torch.from_numpy(scores),
        upsample_hw=(30, 30)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_voc_probs_match_jax():
    """fg + bg VGG16 (full width) at 112^2, batch 3: the CRF unaries,
    including the bg channel's batch-global max, within 1e-4."""
    size = 112
    jfg, tfg = bridged_handles('VGG16', 20, size, seed=0)
    jbg, tbg = bridged_handles('VGG16', 20, size, seed=1)
    cfg = (1.5, 3, 40.0, 13.0, 10.0, 2)
    jseg = jax_hsn.HSNSegmenter(jax_registry.get('VOC2012'), jfg, jbg,
                                cfg=JaxCRFConfig(*cfg))
    tseg = hsn.HSNSegmenter(registry.get('VOC2012'), tfg, tbg,
                            cfg=CRFConfig(*cfg), device='cpu')
    imgs = np.random.default_rng(5).uniform(
        0, 255, (3, size, size, 3)).astype(np.float32)
    want = np.asarray(jseg._probs_fn(jnp.asarray(imgs)))
    got = tseg.probs(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (3, size, size, 21)
    np.testing.assert_allclose(got, want, atol=1e-4)
