"""Carry the JAX package's weights into the port's modules.

Input: the flax variables of a ``VGG16Classifier`` or ``M7Classifier``
(``{'params': ..., 'batch_stats': ...}``) or the ``params`` tree of a
``SECNet`` or ``DSRGNet``, as nested dicts of **numpy** arrays.  This
module never touches jax: the caller converts the leaves
(``jax.tree_util.tree_map(np.asarray, variables)``).

DeepLab mapping: ``trunk/conv{s}_{i}`` -> ``trunk.convs[s-1][i-1]``,
``head/fc6..fc8`` (SEC) or ``branch{rate}/fc6..fc8`` (DSRG) -> the head's
convolutions; ``kernel`` HWIO -> ``weight`` OIHW, ``bias`` as is.

Classifier mapping, per stage and per index i:
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

from wsss_tpu_torch.models.backbones import (M7Classifier, VGG16Classifier,
                                             VGGStage, _Classifier)
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


@torch.no_grad()
def load_flax_variables(model: _Classifier, variables: Mapping
                        ) -> _Classifier:
    """Copy flax variables (numpy leaves) into ``model`` in place and
    return it.  Raises KeyError on a missing entry."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    if isinstance(model, VGG16Classifier):
        named = [(s, params['backbone'][f'layer{i + 1}'],
                  stats.get('backbone', {}).get(f'layer{i + 1}', {}))
                 for i, s in enumerate(model.backbone.stages)]
    elif isinstance(model, M7Classifier):
        named = [(getattr(model, n), params[n], stats.get(n, {}))
                 for n in ('layer1', 'layer2', 'layer3_p1')]
    else:
        raise TypeError(f'no flax mapping for {type(model).__name__}')
    for stage, p, s in named:
        _load_stage(stage, p, s)
    model.head.weight.copy_(_t(params['head']['kernel']).t())
    model.head.bias.copy_(_t(params['head']['bias']))
    return model


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
