"""Checkpoints of the port (counterpart of ``wsss_tpu/io/checkpoint.py``):
training checkpoints and the reference's model triplet.

Training checkpoints keep the reference's ``{root}/step_{step:08d}``
layout and its latest-step discovery (03a model.py:406-415); each step
directory holds one ``torch.save`` file of a dict of tensors (the state
that the reference saves with orbax), loaded with ``weights_only=True``.
An orbax checkpoint of the JAX package does not load here:
``restore_checkpoint`` raises on one.  The model triplet is the format
that crosses between the two packages.

``{sess_id}.json`` holds the architecture descriptor, ``{sess_id}.npz``
the flax ``params`` tree flattened to '/'-joined keys
('backbone/layer1/Conv_0/kernel', 'head/bias', ...) and ``{sess_id}.mat``
the calibrated thresholds as 'optimalScoreThresh'
(01_train/demo.py:189-192).  The weights cross through
``io.flax_bridge``, so a triplet written by either package loads into
the other.  The .npz holds parameters only: a loaded model keeps flax's
initial batch statistics (mean 0, var 1), as the reference's loader does
(``wsss_tpu/cli/common.py:121-127``).  Given ``variables``, the triplet
also gets the reference's Keras .h5 sibling (``io.legacy``).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from wsss_tpu_torch.io.flax_bridge import (classifier_params,
                                           load_flax_variables, stages_of)
from wsss_tpu_torch.models.backbones import _Classifier

STATE_FILE = 'state.pt'


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f'step_{step:08d}')


def save_checkpoint(root: str, step: int, state: Mapping[str, Any]) -> str:
    """Save ``state`` (a dict of tensors, nested dicts of them and plain
    numbers, e.g. ``{'params': net.state_dict()}``) as step ``step``;
    returns the step directory.  The file is written under a temporary
    name and moved into place, so a step directory never holds half a
    checkpoint."""
    path = os.path.abspath(_ckpt_dir(root, step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + '.tmp')
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def latest_step(root: str) -> Optional[int]:
    """Largest saved step (03a model.py:406-415 get_latest_checkpoint)."""
    if not os.path.isdir(root):
        return None
    steps = [int(m.group(1)) for d in os.listdir(root)
             if (m := re.fullmatch(r'step_(\d+)', d))]
    return max(steps) if steps else None


def restore_checkpoint(root: str, step: Optional[int] = None,
                       map_location='cpu') -> Tuple[Dict, int]:
    """(state, step) of the given (or latest) step, its tensors on
    ``map_location``.  Raises FileNotFoundError when there is no step,
    and ValueError on a step directory without the port's state file
    (an orbax checkpoint of the JAX package: its arrays are not read)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {root}')
    path = os.path.join(_ckpt_dir(root, step), STATE_FILE)
    if not os.path.isfile(path):
        raise ValueError(
            f'{_ckpt_dir(root, step)} holds no {STATE_FILE}: not a '
            'checkpoint of this package (an orbax checkpoint of the JAX '
            'package does not load here; the model triplet is the format '
            'that crosses)')
    return torch.load(path, map_location=map_location,
                      weights_only=True), step


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
                   variables: Optional[Mapping] = None) -> None:
    """Write {sess_id}.json (arch), .npz (flat flax params of ``model``)
    and, given thresholds, .mat ('optimalScoreThresh',
    01_train/demo.py:189-192).

    variables: flax variables (params + batch_stats, numpy leaves; e.g.
    ``flax_bridge.classifier_variables(model)``) — when given, also
    writes a Keras-2.2.4-layout {sess_id}.h5 (``io.legacy.write_keras_h5``)
    so the reference's Keras loaders can read the weights
    (01_train/demo.py:63-66)."""
    import scipy.io as sio
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, sess_id + '.json'), 'w') as f:
        json.dump(arch, f, indent=2)
    np.savez(os.path.join(out_dir, sess_id + '.npz'),
             **_flatten(classifier_params(model)))
    if thresholds is not None:
        sio.savemat(os.path.join(out_dir, sess_id + '.mat'),
                    {'optimalScoreThresh': np.asarray(thresholds)})
    if variables is not None:
        from wsss_tpu_torch.io.legacy import write_keras_h5
        write_keras_h5(os.path.join(out_dir, sess_id + '.h5'), variables)


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
