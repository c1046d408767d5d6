"""Carry the JAX package's weights into the port's modules.

Input: the flax variables of a ``VGG16Classifier`` (with or without
BatchNorm), ``M7Classifier`` or ``MVariantClassifier``
(``{'params': ..., 'batch_stats': ...}``; no ``batch_stats`` without
BatchNorm) or the ``params`` tree of a ``SECNet`` or ``DSRGNet``, as
nested dicts of **numpy** arrays.  This module never touches jax: the
caller converts the leaves (``jax.tree_util.tree_map(np.asarray,
variables)``).  ``classifier_params`` / ``classifier_variables`` and ``deeplab_params``
map the other way, a module's weights to the flax tree (the model
triplet and the Keras .h5 writer of ``io.legacy`` take them).

DeepLab mapping: ``trunk/conv{s}_{i}`` -> ``trunk.convs[s-1][i-1]``,
``head/fc6..fc8`` (SEC) or ``branch{rate}/fc6..fc8`` (DSRG) -> the head's
convolutions; ``kernel`` HWIO -> ``weight`` OIHW, ``bias`` as is.

Classifier mapping: stages ``backbone/layer{1..5}`` (VGG16),
``layer1`` / ``layer2`` / ``layer3_p1`` (M7, X1.7) or ``stages_{i}``
(M1-M6), and per stage and index i:
  * ``Conv_i.kernel`` HWIO -> ``convs[i].weight`` OIHW; ``bias`` as is;
  * ``BatchNorm_i.scale`` / ``bias`` and ``batch_stats`` ``mean`` /
    ``var`` -> ``bns[i]`` weight / bias / running_mean / running_var
    (eps 1e-3 is set by the module);
  * ``head.kernel`` [in, out] -> ``head.weight`` [out, in].
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from wsss_tpu_torch.models.backbones import (M7Classifier,
                                             MVariantClassifier,
                                             VGG16Classifier, VGGStage,
                                             _Classifier)
from wsss_tpu_torch.models.deeplab import DSRGNet, SECNet


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().to('cpu', torch.float32).numpy()


def _conv_params(conv: torch.nn.Conv2d) -> dict:
    """A convolution's flax leaves: OIHW -> HWIO kernel, bias as is."""
    return {'kernel': _a(conv.weight.permute(2, 3, 1, 0)),
            'bias': _a(conv.bias)}


@torch.no_grad()
def _load_conv(conv: torch.nn.Conv2d, p: Mapping) -> None:
    conv.weight.copy_(_t(p['kernel']).permute(3, 2, 0, 1))
    conv.bias.copy_(_t(p['bias']))


@torch.no_grad()
def _load_stage(stage: VGGStage, params: Mapping, stats: Mapping) -> None:
    for i, conv in enumerate(stage.convs):
        _load_conv(conv, params[f'Conv_{i}'])
    for i, bn in enumerate(stage.bns):
        p, s = params[f'BatchNorm_{i}'], stats[f'BatchNorm_{i}']
        bn.weight.copy_(_t(p['scale']))
        bn.bias.copy_(_t(p['bias']))
        bn.running_mean.copy_(_t(s['mean']))
        bn.running_var.copy_(_t(s['var']))


def stages_of(model: _Classifier):
    """[(stage, its flax path)] of a classifier."""
    if isinstance(model, VGG16Classifier):
        return [(st, ('backbone', f'layer{i + 1}'))
                for i, st in enumerate(model.backbone.stages)]
    if isinstance(model, M7Classifier):
        return [(getattr(model, n), (n,))
                for n in ('layer1', 'layer2', 'layer3_p1')]
    if isinstance(model, MVariantClassifier):
        return [(st, (f'stages_{i}',)) for i, st in enumerate(model.stages)]
    raise TypeError(f'no flax mapping for {type(model).__name__}')


def _at(tree: Mapping, path) -> Mapping:
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def load_flax_variables(model: _Classifier, variables: Mapping
                        ) -> _Classifier:
    """Copy flax variables (numpy leaves) into ``model`` in place and
    return it.  Raises KeyError on a missing entry."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    for stage, path in stages_of(model):
        _load_stage(stage, _at(params, path),
                    _at(stats, path) if len(stage.bns) else {})
    model.head.weight.copy_(_t(params['head']['kernel']).t())
    model.head.bias.copy_(_t(params['head']['bias']))
    return model


@torch.no_grad()
def classifier_params(model: _Classifier) -> dict:
    """The flax ``params`` tree (numpy float32 leaves) of ``model``:
    the inverse of ``load_flax_variables`` without the batch stats."""
    params: dict = {}
    for stage, path in stages_of(model):
        node = params
        for k in path:
            node = node.setdefault(k, {})
        for i, conv in enumerate(stage.convs):
            node[f'Conv_{i}'] = _conv_params(conv)
        for i, bn in enumerate(stage.bns):
            node[f'BatchNorm_{i}'] = {'scale': _a(bn.weight),
                                      'bias': _a(bn.bias)}
    params['head'] = {'kernel': _a(model.head.weight.t()),
                      'bias': _a(model.head.bias)}
    return params


@torch.no_grad()
def classifier_variables(model: _Classifier) -> dict:
    """The flax variables of ``model``: ``params`` and, where the model
    has BatchNorm, ``batch_stats`` (numpy float32 leaves); the inverse of
    ``load_flax_variables``."""
    stats: dict = {}
    for stage, path in stages_of(model):
        if not len(stage.bns):
            continue
        node = stats
        for k in path:
            node = node.setdefault(k, {})
        for i, bn in enumerate(stage.bns):
            node[f'BatchNorm_{i}'] = {'mean': _a(bn.running_mean),
                                      'var': _a(bn.running_var)}
    out = {'params': classifier_params(model)}
    if stats:
        out['batch_stats'] = stats
    return out


def _deeplab_heads(model):
    if isinstance(model, SECNet):
        return [(model.head, 'head')]
    if isinstance(model, DSRGNet):
        return [(b, f'branch{r}') for b, r in zip(model.branches, model.rates)]
    raise TypeError(f'no flax mapping for {type(model).__name__}')


def load_flax_deeplab(model, params: Mapping):
    """Copy the flax ``params`` tree (numpy leaves) of a SECNet or
    DSRGNet into ``model`` in place and return it.  Raises KeyError on a
    missing entry."""
    heads = [(h, params[key]) for h, key in _deeplab_heads(model)]
    for s, stage in enumerate(model.trunk.convs, start=1):
        for i, conv in enumerate(stage, start=1):
            _load_conv(conv, params['trunk'][f'conv{s}_{i}'])
    for head, p in heads:
        for name in ('fc6', 'fc7', 'fc8'):
            _load_conv(getattr(head, name), p[name])
    return model


@torch.no_grad()
def deeplab_params(model) -> dict:
    """The flax ``params`` tree (numpy float32 leaves) of a SECNet or
    DSRGNet: the inverse of ``load_flax_deeplab``."""
    params = {'trunk': {f'conv{s}_{i}': _conv_params(c)
                        for s, stage in enumerate(model.trunk.convs, start=1)
                        for i, c in enumerate(stage, start=1)}}
    for head, key in _deeplab_heads(model):
        params[key] = {n: _conv_params(getattr(head, n))
                       for n in ('fc6', 'fc7', 'fc8')}
    return params
