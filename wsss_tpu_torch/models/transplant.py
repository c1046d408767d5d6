"""Pour a trained classifier's weights into an IRNet's frozen trunk
(counterpart of ``wsss_tpu/models/transplant.py``).

The reference builds every CAM/IRN network by loading the 01_train
classifier into the trunk layer by layer and asserting that every weight
was consumed (03b_irn/net/common_cnn.py:25-42, assert at :51-52); the
trunk is then frozen and only the heads train.  Here the classifier and
the IRNet trunk share the same modules (VGG stages), so the transplant
copies the trunk's state — parameters and BatchNorm statistics both, since
IRNet runs its trunk in eval mode — after a structure and shape check
standing in for the reference's weight-count assert.
"""
from __future__ import annotations

import torch

from wsss_tpu_torch.models.backbones import M7Classifier, VGG16Classifier

_M7_STAGES = ('layer1', 'layer2', 'layer3_p1')


def _check_match(dst: dict, src: dict, ctx: str) -> None:
    """Same entries and the same shapes (common_cnn.py:51-52); raises
    ValueError."""
    if dst.keys() != src.keys():
        raise ValueError(f'{ctx}: trunk structure mismatch: '
                         f'{sorted(dst.keys() ^ src.keys())}')
    bad = [k for k in dst if dst[k].shape != src[k].shape]
    if bad:
        raise ValueError(f'{ctx}: shape mismatch at {bad[0]}: '
                         f'{tuple(dst[bad[0]].shape)} vs '
                         f'{tuple(src[bad[0]].shape)}')


def _classifier_trunk_state(clf: torch.nn.Module, backbone: str) -> dict:
    """The trunk's state of a classifier: VGG16Classifier holds the tower
    as ``backbone``, M7Classifier the three stages as siblings."""
    if backbone == 'vgg16':
        if not isinstance(clf, VGG16Classifier):
            raise ValueError(f'{type(clf).__name__} carries no VGG16 trunk')
        return clf.backbone.state_dict()
    if not isinstance(clf, M7Classifier):
        raise ValueError(f'{type(clf).__name__} carries no M7 trunk')
    return {f'{n}.{k}': v for n in _M7_STAGES
            for k, v in getattr(clf, n).state_dict().items()}


@torch.no_grad()
def transplant_classifier_trunk(clf: torch.nn.Module, net: torch.nn.Module,
                                backbone: str) -> torch.nn.Module:
    """Copy the classifier's trunk (parameters and BatchNorm statistics)
    into ``net.trunk`` in place, shape-checked, and return ``net``.
    backbone: 'vgg16' | 'm7' (the IRNet wirings)."""
    if backbone not in ('vgg16', 'm7'):
        raise ValueError(f'unknown backbone {backbone!r}')
    src = _classifier_trunk_state(clf, backbone)
    _check_match(net.trunk.state_dict(), src, 'trunk')
    net.trunk.load_state_dict(src)
    return net
