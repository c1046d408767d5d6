"""Carry the JAX package's classifier weights into the port's modules.

Input: the flax variables of a ``VGG16Classifier`` or ``M7Classifier``
as nested dicts of **numpy** arrays (``{'params': ..., 'batch_stats':
...}``).  This module never touches jax: the caller converts the leaves
(``jax.tree_util.tree_map(np.asarray, variables)``).

Mapping, per stage and per index i:
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


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


@torch.no_grad()
def _load_stage(stage: VGGStage, params: Mapping, stats: Mapping) -> None:
    for i, conv in enumerate(stage.convs):
        p = params[f'Conv_{i}']
        conv.weight.copy_(_t(p['kernel']).permute(3, 2, 0, 1))
        conv.bias.copy_(_t(p['bias']))
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
