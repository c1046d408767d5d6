"""img/s of the one-device training steps of a source tree, to compare two
trees of the port on one card within one call.

    python3 scripts/train_step_pair.py [--only cls,sec,irn,irn_adp]
        [--steps 10] TREE [TREE ...]

For each TREE (a checkout of the repo; its own ``wsss_tpu_torch`` and
``chip_smoke.py`` are imported, in a fresh process a tree) it times, at
chip_smoke.py's sizes and random weights: the VGG16 (BN) classifier step
at 321^2, batch 8, 20 classes; SEC's DeepLab step at 321^2, batch 8, 21
classes (the CLI's synthetic cues); IRNet vgg16 at crop 320, batch 8;
IRNet m7 at ADP's crop (224), batch 8, the host-bound one.
Each (or those ``--only`` names): one warm-up step, then ``--steps``
steps on the host clock ending in a synchronize.  Prints one line a
tree, ``PAIR <tree> cls .. irn_adp ..``.  Order the trees parent,
change, change, parent to see the drift.
"""
import argparse
import os
import subprocess
import sys
import time

PATHS = ('cls', 'sec', 'irn', 'irn_adp')


def img_per_s(torch, step, n_img, steps):
    """One warm-up call of step(i), then ``steps`` calls on the host clock
    ending in a synchronize."""
    step(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, 1 + steps):
        step(i)
    torch.cuda.synchronize()
    return n_img * steps / (time.perf_counter() - t0)


def one_tree(tree, only, steps):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    from wsss_tpu_torch.cli.sec_dsrg import _synthetic_cues
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.data.pipeline import SyntheticWSSS
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.backbones import build_classifier, init_random
    from wsss_tpu_torch.train.classifier import ClassifierTrainer
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGTrainer
    smi = cs.phase_device(torch)
    dev = torch.device('cuda', 0)
    size, batch = cs.SIZE, cs.BATCH
    spec = registry.get('VOC2012')
    b = next(SyntheticWSSS('VOC2012', size=size, n_images=batch)
             .batches(batch, with_gt=True))
    raw = torch.as_tensor(b.images, device=dev)
    tags = torch.as_tensor(b.tags, device=dev)
    gen = torch.Generator(dev)
    n_seg = spec.n_seg_classes
    out = {}

    def cls():
        x = _normalizer(spec.norm_cues, dev)(raw)
        tr = ClassifierTrainer(build_classifier('VGG16', spec.n_fg_classes),
                               lr=0.01, schedule='const', device=dev)
        tr.init(torch.Generator().manual_seed(0))
        return img_per_s(torch, lambda i: tr.train_step(
            x, tags, gen.manual_seed(i)), batch, steps)

    def sec():
        xs = _normalizer(spec.norm_sec, dev)(raw)
        c, lab = _synthetic_cues(b.gt, n_seg, (size - 1) // 8 + 1, 0)
        cues = torch.as_tensor(c, device=dev)
        labels = torch.as_tensor(lab, device=dev)
        tr = SECDSRGTrainer('SEC', n_seg, device=dev)
        tr.init(torch.Generator().manual_seed(0))
        return img_per_s(torch, lambda i: tr.train_step(
            xs, raw, cues, labels, gen.manual_seed(i)), batch, steps)

    def irn(backbone, ds, crop, seed):
        tr = irnet.IRNTrainer(backbone, crop_size=crop, device=dev)
        tr.init(torch.Generator().manual_seed(1))
        init_random(tr.net.trunk, torch.Generator().manual_seed(5))
        imgs, lab3, _ = cs.irn_train_batch(seed, batch, crop, n_seg,
                                           tr.path_index)
        xn = _normalizer(registry.get(ds).norm_irn, dev)(
            torch.from_numpy(imgs).to(dev, torch.float32))
        lab3 = [torch.from_numpy(a).to(dev) for a in lab3]
        return img_per_s(torch, lambda i: tr.train_step(xn, *lab3), batch,
                         steps)

    paths = {
        'cls': cls, 'sec': sec,
        'irn': lambda: irn('vgg16', 'VOC2012', size // 16 * 16, 21),
        'irn_adp': lambda: irn(
            'm7', 'ADP-morph',
            registry.get('ADP-morph').clf_size_m7 // 16 * 16, 22)}
    for name in only:
        out[name] = paths[name]()
        torch.cuda.empty_cache()
    print(f'PAIR {tree} ' + ' '.join(f'{k} {v:.2f}' for k, v in out.items())
          + f' img/s ({smi})', flush=True)


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('trees', nargs='+')
    ap.add_argument('--only', default=','.join(PATHS))
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--one', action='store_true', help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        one_tree(a.trees[0], a.only.split(','), a.steps)
    else:
        for t in a.trees:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', '--only', a.only, '--steps',
                            str(a.steps), t], check=True)
