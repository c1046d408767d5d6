"""How far a data-parallel training step's update lies from one device's.

One step of each trainer from the same weights and generator seed, three
ways: on one device, over two shards of one card (``Mesh([cuda:0,
cuda:0])``), and on one device over the first half of the batch (what a
step whose shards were never reduced would resemble).  For each parameter
tensor k it prints ||d_two[k] - d_one[k]|| / ||d_one[k]|| (L2 norms of the
parameter changes), the worst tensors and the same ratio over all
parameters together; for the classifier also the float32 step against the
float64 step from the same weights (the float32 step's own rounding), and
its momentum buffers after two steps: two shards against one device in
float32 and in float64, and float32 against float64 on one device.

Models, at the card's full widths (random weights): the VGG16 (BN)
classifier at 321^2, batch 8, 20 classes, lr 0.01, in float32 and in
float64; SEC's DeepLab at 321^2, batch 8, 21 classes; IRNet vgg16 at crop
320, batch 8.  cuDNN runs deterministic, so a configuration run twice
reads 0 (printed as 'again').

Run on a card:  python3 scripts/dp_step_diag.py
(``--device cpu --size 33`` runs it small on the CPU, to try it out.)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from wsss_tpu_torch.data import registry  # noqa: E402
from wsss_tpu_torch.data.pipeline import SyntheticWSSS  # noqa: E402
from wsss_tpu_torch.methods import irnet  # noqa: E402
from wsss_tpu_torch.methods.gradcam_cues import _normalizer  # noqa: E402
from wsss_tpu_torch.models.backbones import (build_classifier,  # noqa: E402
                                             init_random)
from wsss_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from wsss_tpu_torch.train.classifier import ClassifierTrainer  # noqa: E402
from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer  # noqa: E402

SIZE, BATCH = 321, 8


def params_of(module):
    return {k: p.detach().double().clone()
            for k, p in module.named_parameters()}


def delta(make, step, module_of):
    """{name: change of the parameter} after one step, and the loss."""
    tr = make()
    before = params_of(module_of(tr))
    loss = float(step(tr))
    after = params_of(module_of(tr))
    del tr
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {k: after[k] - v for k, v in before.items()}, loss


def compare(label, got, want):
    """Per tensor and over all: ||got - want|| / ||want||, over the
    tensors the step moved."""
    rows, num, den = [], 0.0, 0.0
    for k, w in want.items():
        dw = float(w.norm())
        if dw == 0.0:
            continue
        e = float((got[k] - w).norm())
        rows.append((e / dw, k, dw))
        num += e * e
        den += dw * dw
    rows.sort(reverse=True)
    worst = ', '.join(f'{k} {r:.3g} (|d| {dw:.3g})' for r, k, dw in rows[:4])
    print(f'  {label}: over all {np.sqrt(num / den):.3g}; worst {worst}; '
          f'median tensor {rows[len(rows) // 2][0]:.3g}')


def three_ways(name, make, step, module_of, dev):
    mesh = Mesh([dev, dev], ('data',))
    one, l1 = delta(make, lambda tr: step(tr, None, BATCH), module_of)
    again, _ = delta(make, lambda tr: step(tr, None, BATCH), module_of)
    two, l2 = delta(make, lambda tr: step(tr, mesh, BATCH), module_of)
    half, lh = delta(make, lambda tr: step(tr, None, BATCH // 2), module_of)
    print(f'[{name}] loss one {l1:.9g}, two shards {l2:.9g}, half batch '
          f'{lh:.9g}')
    compare('again vs one', again, one)
    compare('two shards vs one', two, one)
    compare('half batch vs one', half, one)
    return one


def make_cls(w0, spec, dev):
    """dtype -> a VGG16 (BN) ClassifierTrainer holding the weights w0."""
    def make(dtype):
        net = build_classifier('VGG16', spec.n_fg_classes, dtype=dtype)
        net.load_state_dict(w0)
        return ClassifierTrainer(net.to(dtype), lr=0.01, schedule='const',
                                 device=dev)
    return make


def two_steps(make, x, tags, gen, dev):
    """Two classifier steps (generator seeds 0 and 1) on one device and
    over two shards, in float32 and float64: the momentum buffers, per
    tensor max |a - b| over max |b| (worst four) and the L2 ratio over
    all, two shards against one device in each dtype and float32 against
    float64 on one device."""
    mesh = Mesh([dev, dev], ('data',))
    bufs = {}
    for dtype in (torch.float32, torch.float64):
        for key, m in (('one', None), ('two', mesh)):
            tr = make(dtype)
            for i in range(2):
                tr.train_step(x, tags, gen.manual_seed(i), mesh=m)
            names = [k for k, _ in tr.model.named_parameters()]
            bufs[key, dtype] = {
                k: tr.tx.sgd.state[p]['momentum_buffer'].double()
                for k, p in zip(names, tr.tx.params())}
            del tr
    for label, a, b in (
            ('float32, two shards vs one', ('two', torch.float32),
             ('one', torch.float32)),
            ('float64, two shards vs one', ('two', torch.float64),
             ('one', torch.float64)),
            ('one device, float32 vs float64', ('one', torch.float32),
             ('one', torch.float64))):
        got, want = bufs[a], bufs[b]
        rows = sorted(((float((got[k] - v).abs().max())
                        / max(float(v.abs().max()), 1e-30), k)
                       for k, v in want.items()), reverse=True)
        worst = ', '.join(f'{k} {r:.3g}' for r, k in rows[:4])
        print(f'[cls] momentum buffers after two steps, {label}: max |d| / '
              f'max |b| worst {worst}')
        compare(f'momentum buffers, {label}', got, want)


def main():
    global SIZE
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--size', type=int, default=SIZE)
    args = ap.parse_args()
    SIZE = args.size
    dev = torch.device(args.device)
    if dev.type == 'cuda':
        smi = cs.phase_device(torch)
        dev = torch.device('cuda', 0)
    else:
        smi = 'CPU'
    torch.backends.cudnn.deterministic = True
    spec = registry.get('VOC2012')
    b = next(SyntheticWSSS('VOC2012', size=SIZE, n_images=BATCH)
             .batches(BATCH, with_gt=True))
    raw = torch.as_tensor(b.images, device=dev)
    tags = torch.as_tensor(b.tags, device=dev)
    gen = torch.Generator(dev)
    print(f'({smi})')

    # --- classifier, float32 and float64 from the same weights ------------
    x = _normalizer(spec.norm_cues, dev)(raw)
    w0 = build_classifier('VGG16', spec.n_fg_classes)
    init_random(w0, torch.Generator().manual_seed(0))
    w0 = w0.state_dict()
    deltas = {}
    for dtype in (torch.float32, torch.float64):
        def step(tr, m, n):
            return tr.train_step(x[:n], tags[:n], gen.manual_seed(0),
                                 mesh=m)['loss']
        deltas[dtype] = three_ways(f'cls VGG16 (BN) {dtype}',
                                   lambda: make_cls(w0, spec, dev)(dtype),
                                   step, lambda tr: tr.model, dev)
    print('[cls] float32 step against the float64 step, one device:')
    compare('float32 vs float64', deltas[torch.float32],
            deltas[torch.float64])
    two_steps(make_cls(w0, spec, dev), x, tags, gen, dev)

    # --- SEC DeepLab -------------------------------------------------------
    xs = _normalizer(spec.norm_sec, dev)(raw)
    n_seg = spec.n_seg_classes
    from wsss_tpu_torch.cli.sec_dsrg import _synthetic_cues
    c, lab = _synthetic_cues(b.gt, n_seg, (SIZE - 1) // 8 + 1, 0)
    cues = torch.as_tensor(c, device=dev)
    labels = torch.as_tensor(lab, device=dev)

    def make_sec():
        tr = SECDSRGTrainer('SEC', n_seg, device=dev)
        tr.init(torch.Generator().manual_seed(0))
        return tr
    three_ways('sec DeepLab float32', make_sec, lambda tr, m, n: tr.train_step(
        xs[:n], raw[:n], cues[:n], labels[:n], gen.manual_seed(0),
        mesh=m)['total'], lambda tr: tr.net, dev)

    # --- IRNet vgg16 -------------------------------------------------------
    crop = SIZE // 16 * 16

    def make_irn():
        tr = irnet.IRNTrainer('vgg16', crop_size=crop, device=dev)
        tr.init(torch.Generator().manual_seed(1))
        init_random(tr.net.trunk, torch.Generator().manual_seed(5))
        return tr
    probe = make_irn()
    imgs, lab3, _ = cs.irn_train_batch(21, BATCH, crop, n_seg,
                                       probe.path_index)
    del probe
    xn = _normalizer(spec.norm_irn, dev)(
        torch.from_numpy(imgs).to(dev, torch.float32))
    lab3 = [torch.from_numpy(a).to(dev) for a in lab3]
    three_ways('irn vgg16 float32', make_irn, lambda tr, m, n: tr.train_step(
        xn[:n], *(a[:n] for a in lab3), mesh=m)['total'],
        lambda tr: tr.net, dev)


if __name__ == '__main__':
    main()
