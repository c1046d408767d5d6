"""The port's HSNSegmenter.segment_batch end to end against the JAX
package's (Pallas interpret mode, f32 mean-field state), on the same
bridged weights and images: VOC2012 with fg + bg full-width VGG16 and
DeepGlobe with M7 and drop_last_class, the production CRF configs cut to
2 iterations, 112^2, batch 3.

Tolerance: label agreement >= 0.99.  The reference's grid and filter
input/output are bf16, the port's f32, so pixels near a class tie may
flip (measured 1.0 for VOC and 0.99934 for DeepGlobe)."""
import numpy as np
import pytest
import torch

from test_torch_gradcam import bridged_handles
from wsss_tpu.data import registry as jax_registry
from wsss_tpu.methods import hsn as jax_hsn
from wsss_tpu.ops.crf import config as jax_config
from wsss_tpu.ops.crf import meanfield as jax_mf
from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods import hsn
from wsss_tpu_torch.ops.crf import config

SIZE = 112


@pytest.fixture
def interpret_mxu(monkeypatch):
    monkeypatch.setattr(jax_mf, '_MXU_FORCE_INTERPRET', True)


@pytest.mark.parametrize('dataset,model_type', [('VOC2012', 'VGG16'),
                                                ('DeepGlobe', 'M7')])
def test_segment_batch_matches_jax(interpret_mxu, dataset, model_type):
    spec, jspec = registry.get(dataset), jax_registry.get(dataset)
    n_cls = spec.n_fg_classes
    jfg, tfg = bridged_handles(model_type, n_cls, SIZE, seed=0)
    jbg, tbg = (bridged_handles(model_type, n_cls, SIZE, seed=1)
                if spec.uses_bg_net else (None, None))
    cfg = config.hsn_config(dataset, model_type).astuple()[:5] + (2,)
    drop = not spec.uses_bg_net
    jseg = jax_hsn.HSNSegmenter(jspec, jfg, jbg, model_type=model_type,
                                cfg=jax_config.CRFConfig(*cfg),
                                drop_last_class=drop)
    tseg = hsn.HSNSegmenter(spec, tfg, tbg, model_type=model_type,
                            cfg=config.CRFConfig(*cfg),
                            drop_last_class=drop, device='cpu')
    imgs = np.random.default_rng(9).integers(
        0, 256, (3, SIZE, SIZE, 3)).astype(np.uint8)
    want = np.asarray(jseg.segment_batch(imgs.astype(np.float32)))
    got = tseg.segment_batch(imgs)
    assert got.dtype == torch.int32
    got = got.numpy()
    assert got.shape == want.shape == (3, SIZE, SIZE)
    n_out = spec.n_seg_classes
    assert got.min() >= 0 and got.max() < n_out
    agree = (got == want).mean()
    print(f'{dataset} label agreement {agree:.6f}')
    assert agree >= 0.99, agree
