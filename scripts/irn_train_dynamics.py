#!/usr/bin/env python3
"""IRNet training on one repeated batch, the JAX package's trainer and
the port's side by side on the CPU, from the same flax initial variables:
the total loss of every step at lr 0.1 with max_step 1000 (both trainers'
default) and with max_step equal to the steps run (the schedule that
``cli.irn`` sets from the run's length), on two batches of flat-coloured
blocks built by ``chip_smoke.irn_train_batch``: one whose labels follow
the image's blocks, and one that pairs the same images with the labels
of another draw.

    JAX_PLATFORMS=cpu python3 scripts/irn_train_dynamics.py \\
        [--backbone m7] [--crop 96] [--batch 4] [--steps 10]

Prints one line per (batch, max_step, package) with the totals, whether
the last is below the first, and the largest gap between the packages'
totals.  At crop 96 the /4 grid is 24 wide, so radius 10 holds unclamped
(P = 152 paths, as at the full crop).
"""
import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from wsss_tpu.methods import irnet as jirnet  # noqa: E402
from wsss_tpu_torch.data import registry  # noqa: E402
from wsss_tpu_torch.io.flax_bridge import load_flax_irnet  # noqa: E402
from wsss_tpu_torch.methods import irnet  # noqa: E402
from wsss_tpu_torch.methods.gradcam_cues import _normalizer  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--backbone', default='m7', choices=['m7', 'vgg16'])
    p.add_argument('--crop', type=int, default=96)
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--steps', type=int, default=10)
    a = p.parse_args(argv)
    spec = registry.get('ADP-morph' if a.backbone == 'm7' else 'VOC2012')
    n_seg = spec.n_seg_classes
    pidx = irnet.IRNTrainer(a.backbone, a.crop, device='cpu').path_index
    imgs, follow, _ = chip_smoke.irn_train_batch(21, a.batch, a.crop, n_seg,
                                                 pidx)
    _, other, _ = chip_smoke.irn_train_batch(22, a.batch, a.crop, n_seg,
                                             pidx)
    x = _normalizer(spec.norm_irn, 'cpu')(
        torch.from_numpy(imgs).to(torch.float32)).numpy()
    print(f'IRNet {a.backbone}, crop {a.crop}, batch {a.batch}, radius '
          f'{pidx.radius} (P {len(pidx.search_dst)}), {a.steps} steps, '
          f'lr 0.1, CPU')
    for max_step in (1000, a.steps):
        jt = jirnet.IRNTrainer(a.backbone, n_seg, a.crop,
                               max_step=max_step)
        variables, _ = jt.init(jax.random.PRNGKey(0))
        step = jt.jitted_step()
        for kind, labels in (('labels follow the image', follow),
                             ('labels of another draw', other)):
            jv = variables
            opt = jt.tx.init(jv['params'])
            jtot = []
            for _ in range(a.steps):
                jv, opt, parts = step(jv, opt, jnp.asarray(x),
                                      *map(jnp.asarray, labels))
                jtot.append(float(parts['total']))
            pt = irnet.IRNTrainer(a.backbone, a.crop, max_step=max_step,
                                  device='cpu')
            load_flax_irnet(pt.net, jax.tree_util.tree_map(np.asarray,
                                                           variables))
            ptot = [float(pt.train_step(torch.from_numpy(x), *labels)
                          ['total']) for _ in range(a.steps)]
            gap = max(abs(u - v) for u, v in zip(jtot, ptot))
            for name, tot in (('JAX ', jtot), ('port', ptot)):
                print(f'{kind:24s} max_step {max_step:4d} {name}: '
                      f'{" ".join(f"{v:.4f}" for v in tot)}  last < first: '
                      f'{tot[-1] < tot[0]}')
            print(f'{"":24s} max_step {max_step:4d} largest |JAX - port| '
                  f'{gap:.2e}', flush=True)


if __name__ == '__main__':
    main()
