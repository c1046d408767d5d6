"""Legacy weight formats of the port (counterpart of
``wsss_tpu/io/legacy.py``): Keras .h5 both ways, the thresholds .mat and
the DeepLab init .npy.

Rebuilds the reference's Keras->torch import path
(03b_irn/net/common_cnn.py:25-82): weights are consumed *in model order*
and poured into the target network's conv/BN/dense leaves, with the
weight-count check (common_cnn.py:51-52) kept as the conversion unit
test.  Like the JAX package, these functions work on flax trees —
here nested dicts of numpy arrays, paths as tuples of keys — so a Keras
kernel (HWIO, flax's layout) crosses without a transpose.  The trees
cross into the port's modules through ``io.flax_bridge``
(``classifier_variables`` / ``load_flax_variables`` for classifiers,
``deeplab_params`` / ``load_flax_deeplab`` for SECNet and DSRGNet).
h5py and scipy are imported by the functions that use them.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

Path = Tuple[str, ...]


def read_keras_h5(path: str) -> List[np.ndarray]:
    """Flat weight list in Keras layer order from a `model.save_weights`
    style h5 (groups per layer, 'weight_names' attributes)."""
    import h5py
    out: List[np.ndarray] = []
    with h5py.File(path, 'r') as f:
        root = f['model_weights'] if 'model_weights' in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in root.attrs.get('layer_names', list(root))]
        for lname in layer_names:
            g = root[lname]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in g.attrs.get('weight_names', [])]
            if not wnames:   # fallback: walk datasets
                def visit(name, obj):
                    if isinstance(obj, h5py.Dataset):
                        wnames.append(name)
                g.visititems(visit)
            for wn in wnames:
                out.append(np.asarray(g[wn]))
    return out


def _module_sort_key(mod: str):
    """Definition-order sort key for a module path.

    flax dicts iterate alphabetically, which puts BatchNorm_0 before
    Conv_0; the reference order inside a stage is conv -> relu -> bn
    (common_cnn.py:136-138), i.e. Conv_i then BatchNorm_i.  Natural-sort
    each component, with auto-named Conv_k/BatchNorm_k interleaved as
    (k, conv-first)."""
    key = []
    for comp in mod.split('/'):
        m = re.fullmatch(r'(Conv|Dense)_(\d+)', comp)
        if m:
            key.append((int(m.group(2)), 0, ''))
            continue
        m = re.fullmatch(r'BatchNorm_(\d+)', comp)
        if m:
            key.append((int(m.group(1)), 1, ''))
            continue
        m = re.fullmatch(r'([A-Za-z_]+?)(\d+)(.*)', comp)
        if m:
            key.append((int(m.group(2)), 2, m.group(1) + m.group(3)))
        else:
            # un-numbered components (e.g. 'head') come after numbered
            # siblings (layer1..layerN precede the classifier head)
            key.append((10 ** 9, 2, comp))
    return key


def _leaves(tree: Mapping, prefix: Path = ()):
    """(path, leaf) in jax.tree_util's order for dicts: keys sorted at
    every level, depth first."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _group_modules(tree: Mapping) -> Tuple[Dict[str, Dict[str, Tuple]],
                                          List[str]]:
    by_module: Dict[str, Dict[str, Tuple]] = {}
    for path, leaf in _leaves(tree):
        by_module.setdefault('/'.join(path[:-1]), {})[path[-1]] = (path,
                                                                   leaf)
    order = sorted(by_module, key=_module_sort_key)
    return by_module, order


def _conv_bn_dense_slots(params: Mapping) -> List[Tuple[Path, Any]]:
    """Assignment slots in definition order: for each Conv/Dense module
    (kernel[, bias]), for each BatchNorm (scale, bias) — matching Keras'
    per-layer weight order [kernel, bias] / [gamma, beta, mean, var]."""
    by_module, order = _group_modules(params)
    slots = []
    for mod in order:
        leaves = by_module[mod]
        if 'kernel' in leaves:
            slots.append(leaves['kernel'])
            if 'bias' in leaves:
                slots.append(leaves['bias'])
        elif 'scale' in leaves:   # BatchNorm params: gamma, beta
            slots.append(leaves['scale'])
            slots.append(leaves['bias'])
    return slots


def _bn_stat_slots(batch_stats: Mapping) -> List[Tuple[Path, Any]]:
    by_module, order = _group_modules(batch_stats)
    slots = []
    for mod in order:
        slots.append(by_module[mod]['mean'])
        slots.append(by_module[mod]['var'])
    return slots


def _set_by_path(tree: Mapping, path: Path, value) -> dict:
    """A copy of ``tree`` with the leaf at ``path`` replaced (the dicts
    along the path are copied, the input is left as it was)."""
    node = dict(tree)
    if len(path) == 1:
        node[path[0]] = value
    else:
        node[path[0]] = _set_by_path(tree[path[0]], path[1:], value)
    return node


def load_keras_weights_into(variables: Mapping, weights: List[np.ndarray]
                            ) -> Dict:
    """Pour a Keras-ordered weight list into flax variables (numpy
    leaves); returns new variables, ``variables`` is left as it was.

    Keras serializes per layer: Conv/Dense -> [kernel, bias];
    BatchNorm -> [gamma, beta, moving_mean, moving_var].  The models
    declare layers in the same order, so a single in-order walk with
    interleaving suffices; the total count must match exactly
    (common_cnn.py:51-52).
    """
    params = variables['params']
    stats = variables.get('batch_stats', {})
    pslots = _conv_bn_dense_slots(params)
    sslots = _bn_stat_slots(stats) if stats else []

    # interleave: whenever a BN scale/bias pair is consumed, the next two
    # Keras arrays are its moving stats
    assignments: List[Tuple[Path, Any, str]] = []
    si = i = 0
    while i < len(pslots):
        path, leaf = pslots[i]
        if path[-1] == 'scale':
            assignments.append((path, leaf, 'params'))
            assignments.append(pslots[i + 1] + ('params',))
            assignments.append(sslots[si] + ('stats',))
            assignments.append(sslots[si + 1] + ('stats',))
            si += 2
            i += 2
        else:
            assignments.append((path, leaf, 'params'))
            i += 1
    if len(assignments) != len(weights):
        raise ValueError(
            f'weight count mismatch: model has {len(assignments)} arrays, '
            f'h5 has {len(weights)} (common_cnn.py:51-52 assert)')

    new_params, new_stats = params, stats
    for (path, leaf, kind), w in zip(assignments, weights):
        if w.shape != np.shape(leaf):
            raise ValueError(f'shape mismatch at {path}: '
                             f'{w.shape} vs {np.shape(leaf)}')
        w = w.astype(np.asarray(leaf).dtype)
        if kind == 'params':
            new_params = _set_by_path(new_params, path, w)
        else:
            new_stats = _set_by_path(new_stats, path, w)
    out = dict(variables)
    out['params'] = new_params
    if stats:
        out['batch_stats'] = new_stats
    return out


def keras_weight_groups(variables: Mapping
                        ) -> List[Tuple[str, List[Tuple[str, Any]]]]:
    """(layer_name, [(weight_name, array), ...]) in Keras layer order —
    the exact inverse enumeration of load_keras_weights_into: per
    Conv/Dense a [kernel, bias] group, per BatchNorm a [gamma, beta,
    moving_mean, moving_variance] group, walked in model definition
    order."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    pslots = _conv_bn_dense_slots(params)
    sslots = _bn_stat_slots(stats) if stats else []
    groups: List[Tuple[str, List[Tuple[str, Any]]]] = []
    counters = {'conv2d': 0, 'dense': 0, 'batch_normalization': 0}

    def lname(kind: str) -> str:
        counters[kind] += 1
        return f'{kind}_{counters[kind]}'       # Keras 2.2.4 auto-naming

    si = i = 0
    while i < len(pslots):
        path, leaf = pslots[i]
        if path[-1] == 'scale':
            name = lname('batch_normalization')
            groups.append((name, [
                (f'{name}/gamma:0', leaf),
                (f'{name}/beta:0', pslots[i + 1][1]),
                (f'{name}/moving_mean:0', sslots[si][1]),
                (f'{name}/moving_variance:0', sslots[si + 1][1])]))
            si += 2
            i += 2
            continue
        kind = 'conv2d' if np.ndim(leaf) == 4 else 'dense'
        name = lname(kind)
        ws = [(f'{name}/kernel:0', leaf)]
        i += 1
        if i < len(pslots):
            npath, nleaf = pslots[i]
            if npath[-1] == 'bias' and npath[:-1] == path[:-1]:
                ws.append((f'{name}/bias:0', nleaf))
                i += 1
        groups.append((name, ws))
    return groups


def write_keras_h5(path: str, variables: Mapping) -> None:
    """Keras-2.2.4-layout `save_weights` h5 from flax variables (numpy
    leaves; ``flax_bridge.classifier_variables`` of a port model) — the
    inverse of read_keras_h5, so that the reference's Keras 2.2.4
    `model.load_weights(by_name=False)` reads the port's weights
    (01_train/demo.py:63-66): per-layer groups, root 'layer_names' attr,
    per-group 'weight_names' attrs, kernels in HWIO."""
    import h5py
    groups = keras_weight_groups(variables)
    with h5py.File(path, 'w') as f:
        f.attrs['layer_names'] = np.array(
            [g[0].encode() for g in groups])
        f.attrs['backend'] = b'tensorflow'
        f.attrs['keras_version'] = b'2.2.4'
        for name, ws in groups:
            g = f.create_group(name)
            g.attrs['weight_names'] = np.array(
                [wn.encode() for wn, _ in ws])
            for wn, arr in ws:
                g.create_dataset(wn, data=np.asarray(arr, np.float32))


def load_thresholds_mat(path: str, num_classes: int,
                        clamp_min: float = 1.0 / 3.0) -> np.ndarray:
    """.mat 'optimalScoreThresh', clamped to >= 1/3 (common_cnn.py:39);
    flat-0.5 fallback when missing (adp_cues.py:118-120)."""
    import scipy.io as sio
    if not os.path.exists(path):
        return np.full((num_classes,), 0.5, np.float32)
    t = np.asarray(sio.loadmat(path)['optimalScoreThresh'],
                   np.float32).reshape(-1)[:num_classes]
    return np.maximum(t, clamp_min)


def load_deeplab_init_npy(path: str, params: Mapping,
                          skip_final: bool = True) -> Dict:
    """Load the reference's DeepLab init weights into a SECNet/DSRGNet
    flax ``params`` tree (numpy leaves; ``flax_bridge.deeplab_params`` of
    a port model); returns the new tree.

    The reference initializes SEC from `init.npy` and DSRG from
    `vgg16_deeplab_aspp.npy` (03a model.py:78-81): a pickled dict
    `layer -> {"w": HWIO kernel, "b": bias}` consumed by name at
    SEC.py:286-338 / DSRG.py's get_weights_and_bias.  fc8 stays randomly
    initialized like the reference (SEC.py:329-336) unless
    skip_final=False.

    Name mapping: conv{s}_{i} -> trunk/conv{s}_{i}; SEC fc6/fc7/fc8 ->
    head/fc{n}; DSRG fc{n}_{k} -> branch{rate_k}/fc{n} with rates
    (6,12,18,24) for k=1..4.
    """
    init = np.load(path, encoding='latin1', allow_pickle=True).item()
    rates = (6, 12, 18, 24)

    def target_path(layer: str):
        if layer.startswith('conv'):
            return ('trunk', layer)
        m = re.fullmatch(r'fc(\d)(?:_(\d))?', layer)
        if not m:
            return None
        n, k = m.group(1), m.group(2)
        if skip_final and n == '8':
            return None
        if k is None:                      # SEC LargeFOV head
            return ('head', f'fc{n}')
        return (f'branch{rates[int(k) - 1]}', f'fc{n}')

    out = dict(params)
    loaded = 0
    for layer, wb in init.items():
        tp = target_path(layer)
        if tp is None:
            continue
        node = params
        ok = True
        for key in tp:
            if key not in node:
                ok = False
                break
            node = node[key]
        if not ok:
            continue
        w = np.asarray(wb['w'], np.float32)
        b = np.asarray(wb['b'], np.float32)
        if w.shape != np.shape(node['kernel']):
            raise ValueError(f'{layer}: kernel shape {w.shape} vs '
                             f'{np.shape(node["kernel"])}')
        out = _set_by_path(out, tp + ('kernel',), w)
        out = _set_by_path(out, tp + ('bias',), b)
        loaded += 1
    if loaded == 0:
        raise ValueError(f'no layers from {path} matched the model')
    return out
