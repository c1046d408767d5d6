"""Carry the JAX package's weights into the port's modules.

Input: the flax variables of a ``VGG16Classifier`` (with or without
BatchNorm), ``M7Classifier`` or ``MVariantClassifier``
(``{'params': ..., 'batch_stats': ...}``; no ``batch_stats`` without
BatchNorm) or the ``params`` tree of a ``SECNet`` or ``DSRGNet``, as
nested dicts of **numpy** arrays.  This module never touches jax: the
caller converts the leaves (``jax.tree_util.tree_map(np.asarray,
variables)``).  ``classifier_params`` maps the other way, a classifier's
weights to the flax ``params`` tree (the model triplet writes it).

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
    def a(t):
        return t.detach().to('cpu', torch.float32).numpy()

    params: dict = {}
    for stage, path in stages_of(model):
        node = params
        for k in path:
            node = node.setdefault(k, {})
        for i, conv in enumerate(stage.convs):
            node[f'Conv_{i}'] = {'kernel': a(conv.weight.permute(2, 3, 1, 0)),
                                 'bias': a(conv.bias)}
        for i, bn in enumerate(stage.bns):
            node[f'BatchNorm_{i}'] = {'scale': a(bn.weight),
                                      'bias': a(bn.bias)}
    params['head'] = {'kernel': a(model.head.weight.t()),
                      'bias': a(model.head.bias)}
    return params


def load_flax_deeplab(model, params: Mapping):
    """Copy the flax ``params`` tree (numpy leaves) of a SECNet or
    DSRGNet into ``model`` in place and return it.  Raises KeyError on a
    missing entry."""
    if isinstance(model, SECNet):
        heads = [(model.head, params['head'])]
    elif isinstance(model, DSRGNet):
        heads = [(b, params[f'branch{r}'])
                 for b, r in zip(model.branches, model.rates)]
    else:
        raise TypeError(f'no flax mapping for {type(model).__name__}')
    for s, stage in enumerate(model.trunk.convs, start=1):
        for i, conv in enumerate(stage, start=1):
            _load_conv(conv, params['trunk'][f'conv{s}_{i}'])
    for head, p in heads:
        for name in ('fc6', 'fc7', 'fc8'):
            _load_conv(getattr(head, name), p[name])
    return model
