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

IRNet mapping (``load_flax_irnet`` / ``irnet_variables``; also
``ResNet50CAM``): the trunk under ``trunk`` (``backbone`` for
ResNet50CAM) as above for the VGG16 and M7 stages; a ResNet50's
``conv1`` / ``bn1`` and blocks ``layer{s}_b{b}`` with ``Conv_i``,
``FixedBatchNorm_i``, ``downsample_conv`` / ``downsample_bn``, each
FixedBatchNorm's ``scale`` / ``bias`` params and ``batch_stats`` ``mean`` /
``var`` into its parameters and buffers; each head block ``fc_*`` with
``Conv_0.kernel`` (no bias) and ``GroupNorm_0.scale`` / ``bias``, the last
1x1 convolutions (``fc_edge6`` .. ``fc_dp7b``, ``classifier``) with
their kernel and, where they have one, bias.
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
from wsss_tpu_torch.models.irn import IRNet, M7Stages, _GNConv
from wsss_tpu_torch.models.resnet50 import (FixedBatchNorm, ResNet50,
                                            ResNet50CAM)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().to('cpu', torch.float32).numpy()


def _conv_params(conv: torch.nn.Conv2d) -> dict:
    """A convolution's flax leaves: OIHW -> HWIO kernel, bias as is (where
    the convolution has one)."""
    out = {'kernel': _a(conv.weight.permute(2, 3, 1, 0))}
    if conv.bias is not None:
        out['bias'] = _a(conv.bias)
    return out


@torch.no_grad()
def _load_conv(conv: torch.nn.Conv2d, p: Mapping) -> None:
    conv.weight.copy_(_t(p['kernel']).permute(3, 2, 0, 1))
    if conv.bias is not None:
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


def _resnet_leaves(trunk: ResNet50, path):
    yield trunk.conv1, path + ('conv1',)
    yield trunk.bn1, path + ('bn1',)
    for si, stage in enumerate(trunk.blocks):
        for bi, block in enumerate(stage):
            at = path + (f'layer{si + 1}_b{bi}',)
            for i, (conv, bn) in enumerate(zip(block.convs, block.bns)):
                yield conv, at + (f'Conv_{i}',)
                yield bn, at + (f'FixedBatchNorm_{i}',)
            if block.downsample_conv is not None:
                yield block.downsample_conv, at + ('downsample_conv',)
                yield block.downsample_bn, at + ('downsample_bn',)


def _irnet_leaves(model):
    """(module, flax path) of every leaf module of an IRNet or a
    ResNet50CAM: VGG stages, convolutions, GroupNorms, FixedBatchNorms."""
    if isinstance(model, ResNet50CAM):
        yield from _resnet_leaves(model.backbone, ('backbone',))
        yield model.classifier, ('classifier',)
        return
    if not isinstance(model, IRNet):
        raise TypeError(f'no flax mapping for {type(model).__name__}')
    trunk = model.trunk
    if isinstance(trunk, ResNet50):
        yield from _resnet_leaves(trunk, ('trunk',))
    elif isinstance(trunk, M7Stages):
        for n in ('layer1', 'layer2', 'layer3_p1'):
            yield getattr(trunk, n), ('trunk', n)
    else:
        for i, st in enumerate(trunk.stages):
            yield st, ('trunk', f'layer{i + 1}')
    for name, mod in model.named_children():
        if isinstance(mod, _GNConv):
            yield mod.conv, (name, 'Conv_0')
            yield mod.gn, (name, 'GroupNorm_0')
        elif isinstance(mod, torch.nn.Conv2d):
            yield mod, (name,)


@torch.no_grad()
def load_flax_irnet(model, variables: Mapping):
    """Copy the flax variables (numpy leaves) of an IRNet (any trunk) or
    a ResNet50CAM into ``model`` in place and return it.  Raises KeyError
    on a missing entry."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    for mod, path in _irnet_leaves(model):
        p = _at(params, path)
        if isinstance(mod, VGGStage):
            _load_stage(mod, p, _at(stats, path) if len(mod.bns) else {})
        elif isinstance(mod, torch.nn.Conv2d):
            _load_conv(mod, p)
        else:                   # GroupNorm / FixedBatchNorm
            w = mod.scale if isinstance(mod, FixedBatchNorm) else mod.weight
            w.copy_(_t(p['scale']))
            mod.bias.copy_(_t(p['bias']))
            if isinstance(mod, FixedBatchNorm):
                s = _at(stats, path)
                mod.mean.copy_(_t(s['mean']))
                mod.var.copy_(_t(s['var']))
    return model


@torch.no_grad()
def irnet_variables(model) -> dict:
    """The flax variables (``params`` and ``batch_stats``, numpy float32
    leaves) of an IRNet or a ResNet50CAM: the inverse of
    ``load_flax_irnet``."""
    params: dict = {}
    stats: dict = {}

    def node(tree, path):
        for k in path:
            tree = tree.setdefault(k, {})
        return tree
    for mod, path in _irnet_leaves(model):
        if isinstance(mod, VGGStage):
            p = node(params, path)
            for i, conv in enumerate(mod.convs):
                p[f'Conv_{i}'] = _conv_params(conv)
            for i, bn in enumerate(mod.bns):
                p[f'BatchNorm_{i}'] = {'scale': _a(bn.weight),
                                       'bias': _a(bn.bias)}
                node(stats, path)[f'BatchNorm_{i}'] = {
                    'mean': _a(bn.running_mean), 'var': _a(bn.running_var)}
        elif isinstance(mod, torch.nn.Conv2d):
            node(params, path[:-1])[path[-1]] = _conv_params(mod)
        else:
            fixed = isinstance(mod, FixedBatchNorm)
            node(params, path[:-1])[path[-1]] = {
                'scale': _a(mod.scale if fixed else mod.weight),
                'bias': _a(mod.bias)}
            if fixed:
                node(stats, path[:-1])[path[-1]] = {'mean': _a(mod.mean),
                                                    'var': _a(mod.var)}
    out = {'params': params}
    if stats:
        out['batch_stats'] = stats
    return out
