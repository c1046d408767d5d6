"""The reference's model triplet in the port (counterpart of
``wsss_tpu/io/checkpoint.py`` ``export_triplet`` / ``import_triplet``).

``{sess_id}.json`` holds the architecture descriptor, ``{sess_id}.npz``
the flax ``params`` tree flattened to '/'-joined keys
('backbone/layer1/Conv_0/kernel', 'head/bias', ...) and ``{sess_id}.mat``
the calibrated thresholds as 'optimalScoreThresh'
(01_train/demo.py:189-192).  The weights cross through
``io.flax_bridge``, so a triplet written by either package loads into
the other.  The .npz holds parameters only: a loaded model keeps flax's
initial batch statistics (mean 0, var 1), as the reference's loader does
(``wsss_tpu/cli/common.py:121-127``).  The orbax training checkpoints of
the reference are not part of the port.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from wsss_tpu_torch.io.flax_bridge import (classifier_params,
                                           load_flax_variables, stages_of)
from wsss_tpu_torch.models.backbones import _Classifier


def _flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + '/'))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split('/')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def export_triplet(out_dir: str, sess_id: str, arch: Dict,
                   model: _Classifier,
                   thresholds: Optional[np.ndarray] = None,
                   variables=None) -> None:
    """Write {sess_id}.json (arch), .npz (flat flax params of ``model``)
    and, given thresholds, .mat.  ``variables`` (the reference's Keras
    .h5 sibling) is not ported yet (ROADMAP queue 1 item 3)."""
    if variables is not None:
        raise NotImplementedError(
            'the Keras .h5 sibling of the triplet is not ported yet '
            '(ROADMAP queue 1 item 3, io/legacy.py)')
    import scipy.io as sio
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, sess_id + '.json'), 'w') as f:
        json.dump(arch, f, indent=2)
    np.savez(os.path.join(out_dir, sess_id + '.npz'),
             **_flatten(classifier_params(model)))
    if thresholds is not None:
        sio.savemat(os.path.join(out_dir, sess_id + '.mat'),
                    {'optimalScoreThresh': np.asarray(thresholds)})


def import_triplet(out_dir: str, sess_id: str, model: _Classifier
                   ) -> Tuple[Dict, _Classifier, Optional[np.ndarray]]:
    """Inverse of export_triplet: (arch, model loaded in place,
    thresholds or None).  Every parameter of ``model`` must be in the
    .npz with its shape (KeyError / ValueError otherwise); BatchNorm
    statistics are reset to flax's initial mean 0 / var 1."""
    import scipy.io as sio
    with open(os.path.join(out_dir, sess_id + '.json')) as f:
        arch = json.load(f)
    data = np.load(os.path.join(out_dir, sess_id + '.npz'))
    flat = {}
    for key, leaf in _flatten(classifier_params(model)).items():
        arr = data[key]
        if arr.shape != leaf.shape:
            raise ValueError(f'{sess_id}.npz: {key} has shape {arr.shape}, '
                             f'the model wants {leaf.shape}')
        flat[key] = arr.astype(np.float32)
    stats: dict = {}
    for stage, path in stages_of(model):
        node = stats
        for k in path:
            node = node.setdefault(k, {})
        for i, bn in enumerate(stage.bns):
            n = bn.num_features
            node[f'BatchNorm_{i}'] = {'mean': np.zeros(n, np.float32),
                                      'var': np.ones(n, np.float32)}
    load_flax_variables(model, {'params': _unflatten(flat),
                                'batch_stats': stats})
    mat_path = os.path.join(out_dir, sess_id + '.mat')
    thresholds = None
    if os.path.exists(mat_path):
        thresholds = np.asarray(
            sio.loadmat(mat_path)['optimalScoreThresh']).reshape(-1)
    return arch, model, thresholds
