"""Dense-CRF configurations (a copy of the JAX package's tables).

Mirrors the per-dataset CRF parameter tables shipped with the reference:
  * SEC train/test configs — 03a_sec-dsrg/SEC.py:18-30
  * DSRG train/test configs — 03a_sec-dsrg/DSRG.py:77-78
  * HistoSegNet per-dataset configs — 03c_hsn/demo.py:156-165
    (ADP uses learned configs from {morph,func}_optimal_pcc.npy,
     03c_hsn/demo.py:379-380, read by ``load_learned_config``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CRFConfig:
    """Parameters of a 2-kernel dense CRF (Gaussian + bilateral).

    Matches pydensecrf's DenseCRF2D.addPairwiseGaussian(sxy, compat) +
    addPairwiseBilateral(sxy, srgb, compat) (03c_hsn/utilities.py:435-440).
    """
    g_sxy: float
    g_compat: float
    bi_sxy: float
    bi_srgb: float
    bi_compat: float
    iterations: int = 5

    def astuple(self):
        return (self.g_sxy, self.g_compat, self.bi_sxy, self.bi_srgb,
                self.bi_compat, self.iterations)


# --- SEC (SEC.py:18-30) ---
SEC_TRAIN_DEFAULT = CRFConfig(3 / 12, 3, 80 / 12, 13, 10, 5)
SEC_TEST = {
    'VOC2012': CRFConfig(3, 3, 80, 13, 10, 10),
    'DeepGlobe': CRFConfig(3, 3, 80, 13, 10, 10),
    'DeepGlobe_balanced': CRFConfig(3, 3, 80, 13, 10, 10),
    'ADP-morph': CRFConfig(1, 20, 10, 40, 50, 5),
    'ADP-func': CRFConfig(3, 40, 10, 4, 25, 5),
}

# --- DSRG (DSRG.py:77-78): one config for all datasets ---
DSRG_TRAIN = CRFConfig(3 / 12, 3, 80 / 12, 13, 10, 5)
DSRG_TEST = CRFConfig(3, 3, 80, 13, 10, 10)

# --- HistoSegNet (03c_hsn/demo.py:156-165) ---
HSN_TEST = {
    ('VOC2012', 'VGG16'): CRFConfig(3 / 2, 3, 80 / 2, 13, 10, 10),
    ('VOC2012', 'M7'): CRFConfig(3 / 12 / 4, 3, 80 / 12 / 4, 13, 10, 10),
    ('DeepGlobe', None): CRFConfig(3 / 2, 3, 80 / 2, 13, 10, 10),
    ('DeepGlobe_balanced', None): CRFConfig(3 / 2, 3, 80 / 2, 13, 10, 10),
    # ADP configs are learned ({morph,func}_optimal_pcc.npy,
    # 03c_hsn/demo.py:379); these defaults mirror the SEC test values.
    ('ADP-morph', None): CRFConfig(1, 20, 10, 40, 50, 5),
    ('ADP-func', None): CRFConfig(3, 40, 10, 4, 25, 5),
}


def hsn_config(dataset: str, model_type: str = None) -> CRFConfig:
    for key in ((dataset, model_type), (dataset, None)):
        if key in HSN_TEST:
            return HSN_TEST[key]
    raise KeyError(f'no HSN CRF config for {dataset}/{model_type}')


def load_learned_config(npy_path: str) -> CRFConfig:
    """Learned ADP CRF parameters from {morph,func}_optimal_pcc.npy
    (03c_hsn/demo.py:379-380): a row of [g_sxy, g_compat, bi_sxy, bi_srgb,
    bi_compat, n_infer].  (The reference's unused ``iterations=``
    argument is left out: the count comes from the file.)"""
    import numpy as np
    row = np.asarray(np.load(npy_path)).reshape(-1)[:6]
    return CRFConfig(float(row[0]), float(row[1]), float(row[2]),
                     float(row[3]), float(row[4]), int(row[5]))


# --- IRNet tuned hyperparameters shipped with the reference
# (03b_irn/demo_sem_seg.py:8-18 via BASELINE.md): (conf_fg_thres,
# exp_times) per dataset x model family.  The CLI falls back to (0.5, 8)
# for a pair not listed.
IRN_TUNED = {
    ('ADP-morph', 'VGG16'): (0.5, 2), ('ADP-morph', 'X1.7'): (0.5, 1),
    ('ADP-func', 'VGG16'): (0.7, 3), ('ADP-func', 'X1.7'): (0.3, 1),
    ('VOC2012', 'VGG16'): (0.5, 8), ('VOC2012', 'M7'): (0.7, 3),
    ('DeepGlobe', 'VGG16'): (0.5, 4), ('DeepGlobe', 'M7'): (0.5, 8),
    ('DeepGlobe_balanced', 'VGG16'): (0.4, 7),
    ('DeepGlobe_balanced', 'M7'): (0.7, 7),
}

# --- IRNet ir-label refinement (misc.imutils.crf_inference_label upstream:
# gaussian sxy=3 compat=3, bilateral sxy=50 srgb=5 compat=10, 10 iters) ---
IRN_LABEL = CRFConfig(3, 3, 50, 5, 10, 10)
