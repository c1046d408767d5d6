"""Inter-stage artifact IO of the port (a copy of
``wsss_tpu/io/artifacts.py``): the reference's filesystem data contract.

Keeps bit-compatible formats so artifacts interchange with the reference:
  * localization_cues.pickle — dict '{idx}_labels' -> passing class indices,
    '{idx}_cues' -> 3xN (class,row,col) int array at the 41x41 seed grid
    (written 02_cues/demo.py:217-222,320-321; read 03a model.py:174-186).
  * per-image CAM .npy dicts {"keys","cam","high_res"}
    (make_cam.py:78-88; DeepGlobe omits high_res).

Inside this package stages hand tensors in memory; these writers exist for
reference-compat dumps and for resuming from reference-produced artifacts.
Host numpy only: callers move cue volumes off the device first.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def write_cue_pickle(path: str, cues: Mapping[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(dict(cues), f)


def read_cue_pickle(path: str) -> Dict[str, np.ndarray]:
    with open(path, 'rb') as f:
        return pickle.load(f)


def pack_cues(onehot_batch, class_inds: Sequence[np.ndarray],
              indices: Sequence[int],
              out: Optional[Dict[str, np.ndarray]] = None
              ) -> Dict[str, np.ndarray]:
    """Pack a one-hot cue volume [B,H,W,C] into the pickle dict format.

    class_inds[i]: the passing class indices recorded as '{idx}_labels'
    (VOC: fg indices + 1; DeepGlobe: raw; ADP: valid-set indices —
    02_cues/demo.py:205-208,300-309).
    """
    out = {} if out is None else out
    oh = np.asarray(onehot_batch)
    for i, idx in enumerate(indices):
        out['%d_labels' % idx] = np.asarray(class_inds[i])
        out['%d_cues' % idx] = np.array(
            np.where(np.moveaxis(oh[i], -1, 0)))
    return out


def unpack_cues(cues: Mapping[str, np.ndarray], idx: int,
                shape_hwc) -> np.ndarray:
    """Dense [H,W,C] float32 cue volume for image `idx`."""
    h, w, c = shape_hwc
    dense = np.zeros((h, w, c), np.float32)
    sp = cues.get('%d_cues' % idx)
    if sp is not None and sp.size:
        dense[sp[1], sp[2], sp[0]] = 1.0
    return dense


def write_cam_npy(path: str, keys: np.ndarray, cam: np.ndarray,
                  high_res: Optional[np.ndarray] = None) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    d = {'keys': np.asarray(keys), 'cam': np.asarray(cam)}
    if high_res is not None:
        d['high_res'] = np.asarray(high_res)
    np.save(path, d)


def read_cam_npy(path: str) -> Dict[str, np.ndarray]:
    return np.load(path, allow_pickle=True).item()
