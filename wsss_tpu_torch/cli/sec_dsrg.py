"""03a — SEC / DSRG prediction (counterpart of the predict half of
``wsss_tpu/cli/sec_dsrg.py``): FCN forward -> upscale -> test-time dense
CRF -> argmax, one image at its native size at a time.

Reference semantics (03a model.py:684-696): for every dataset but
DeepGlobe the softmax score map AND the original image are resized to
the ground truth's resolution and the test CRF runs there; for DeepGlobe
the CRF runs at network resolution and only the argmax is resized.

Training, dataset IO, checkpoints and the IoU reports of the reference's
``main()`` are not ported yet (ROADMAP queue 1 items 10 and 12).
"""
from __future__ import annotations

from typing import Tuple

import torch

from wsss_tpu_torch.data import registry
from wsss_tpu_torch.methods.gradcam_cues import _normalizer
from wsss_tpu_torch.ops.crf import config as crf_config
from wsss_tpu_torch.ops.crf.meanfield import mean_field
from wsss_tpu_torch.ops.filters import resize_bilinear, resize_nearest
from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor

SEED_SIZE = 41  # 03a model.py:35

# Per-dataset defaults of the reference's sweep (03a_sec-dsrg/demo.py:
# 51-72): (cue threshold, epochs).
SWEEP_DEFAULTS = {
    ('ADP-morph', 'SEC'): (0.9, 8), ('ADP-morph', 'DSRG'): (0.9, 8),
    ('ADP-func', 'SEC'): (0.9, 8), ('ADP-func', 'DSRG'): (0.9, 8),
    ('VOC2012', 'SEC'): (0.2, 16), ('VOC2012', 'DSRG'): (0.2, 6),
    ('DeepGlobe', 'SEC'): (0.3, 100), ('DeepGlobe', 'DSRG'): (0.3, 100),
    ('DeepGlobe_balanced', 'SEC'): (0.4, 100),
    ('DeepGlobe_balanced', 'DSRG'): (0.4, 100),
}


def predict_crf_config(dataset: str, method: str) -> crf_config.CRFConfig:
    """The test-time CRF of a dataset and method (SEC.py:18-30,
    DSRG.py:77-78)."""
    if method.upper() == 'SEC':
        return crf_config.SEC_TEST.get(dataset, crf_config.DSRG_TEST)
    return crf_config.DSRG_TEST


def predict_image(predictor: SECDSRGPredictor, spec: registry.DatasetSpec,
                  method: str, native, out_hw: Tuple[int, int],
                  size: int = 321, ref_round: bool = False) -> torch.Tensor:
    """Labels [out_h, out_w] int32 (on the predictor's device) of one
    RGB image ``native`` [H, W, 3] 0..255 (uint8 or float, numpy or a
    tensor) — the loop body of the reference's predict task
    (cli/sec_dsrg.py:214-249).  ``ref_round`` is the CRF's CPU-test
    switch (``mean_field``)."""
    dev = predictor.device
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    cfg = predict_crf_config(spec.name, method)
    native = torch.as_tensor(native).to(dev, torch.float32)
    net_in = resize_bilinear(native, (size, size))
    norm = _normalizer(spec.norm_sec, dev)
    logits = predictor.predict_logits(norm(net_in[None]))
    probs = torch.softmax(resize_bilinear(logits, (size, size)), dim=-1)
    if 'DeepGlobe' not in spec.name:
        # score map and image to GT resolution, CRF there
        probs = torch.clamp(resize_bilinear(probs, out_hw), 1e-8, 1.0)
        probs = probs / probs.sum(-1, keepdim=True)
        guide = (native if tuple(native.shape[:2]) == out_hw
                 else resize_bilinear(native, out_hw))
        q = mean_field(probs, guide[None], cfg, ref_round=ref_round)
        return torch.argmax(q, dim=-1)[0].to(torch.int32)
    q = mean_field(probs, net_in[None], cfg, ref_round=ref_round)
    pred = torch.argmax(q, dim=-1)[0]
    if tuple(pred.shape) != out_hw:
        pred = resize_nearest(pred.to(torch.float32)[..., None],
                              out_hw)[..., 0]
    return pred.to(torch.int32)


def main(argv=None):
    raise NotImplementedError(
        'the SEC/DSRG command line needs the dataset pipeline, checkpoints '
        'and IoU reports, which are not ported yet (ROADMAP queue 1 item '
        '12); call predict_image with a SECDSRGPredictor instead')


if __name__ == '__main__':
    main()
