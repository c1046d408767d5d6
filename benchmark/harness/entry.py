"""What every entry driver shares.

An entry (``entries/<name>.py``, class ``Entry``) builds the program of
its cell in set-up and warms its shapes up, then serves the runner:

  * ``inputs(i)`` the host input of call i, ``call(i, inp)`` one closed-
    loop call, returning the images it completed;
  * ``keep(calls)`` which calls' outputs to keep, ``program_outputs()``
    what was kept, ``reference_outputs(mode)`` the plain reference's for
    the same calls in 'fp32' or 'tf32', ``gaps(got, ref)`` the numbers
    compared;
  * ``work()`` the FLOPs an image, ``release()`` frees the program before
    the check."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness import traffic as T
from benchmark.harness import weights as W


class EntryBase:
    MACS = 'forward_macs'       # the configuration's count of a call's work

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.pool = T.image_pool(seed, traffic, device)
        self.order = T.call_order(seed, traffic, traffic['order_calls'])
        self.program = None
        self.want, self.kept, self._i = set(), {}, -1

    def keep(self, calls: List[int]) -> None:
        self.want = set(calls)

    def keeping(self) -> bool:
        return self._i in self.want

    def inputs(self, i: int) -> np.ndarray:
        return T.gather(self.pool, self.order[i % len(self.order)])

    def warm_up(self, first: int = 0) -> None:
        for i in range(first, first + self.traffic['warmup_calls']):
            self.call(-1, self.inputs(i))

    def program_outputs(self) -> dict:
        return self.kept

    def work(self) -> dict:
        macs = getattr(spec.flops(self.cfg['name']), self.MACS)(self.cfg)
        return {'flops_per_image': 2 * macs['total'],
                'conv_flops_per_image': 2 * macs['conv']}

    def release(self) -> None:
        self.program = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


def classifier_handles(cfg: dict, seed: int, device, ranges,
                       threshold: float):
    """({network: layers}, [handle, ...]) of the configuration's
    classifiers: built on ``device`` with the benchmark's weights, each
    hooked for a range, their Grad-CAM weights computed by the program."""
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.models.backbones import build_classifier

    wseed = T.sub_seed(seed, 'weights')
    shapes = spec.flops(cfg['name']).kernel_shapes(cfg)
    layers, handles = {}, []
    for k, (name, classes) in enumerate(cfg['networks'].items()):
        layers[name] = W.make_layers(shapes[name], wseed + k, device)
        with torch.device(device):
            model = build_classifier(cfg['model_tag'], classes,
                                     dtype=torch.float32)
        W.load_into(model, layers[name])
        ranges.hook(model, f'net.{name}')
        handles.append(_ClassifierHandle(model, threshold,
                                         cfg['input_size'], device=device))
    return layers, handles
