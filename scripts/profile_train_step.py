"""Where a one-device IRNet training step of a source tree spends its host
time: the host-bound step (m7 at ADP's crop 224, batch 8, random
weights, chip_smoke.py's synthetic affinity batch).

    python3 scripts/profile_train_step.py TREE [TREE ...]

For each TREE (a checkout of the repo, imported in a fresh process) it
runs 3 warm-up steps, then STEPS steps three ways: on the host clock
ending in a synchronize; under torch.profiler (device busy time, device
events and host-side aten calls a step, the aten ops called most); under
cProfile (the Python functions with the most own time).  Prints lines
starting ``PROF <tree>``.
"""
import cProfile
import io
import os
import pstats
import subprocess
import sys
import time

STEPS = 20


def one_tree(tree):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods import irnet
    from wsss_tpu_torch.methods.gradcam_cues import _normalizer
    from wsss_tpu_torch.models.backbones import init_random
    smi = cs.phase_device(torch)
    dev = torch.device('cuda', 0)
    adp = registry.get('ADP-morph')
    crop = adp.clf_size_m7 // 16 * 16
    tr = irnet.IRNTrainer('m7', crop_size=crop, device=dev)
    tr.init(torch.Generator().manual_seed(1))
    init_random(tr.net.trunk, torch.Generator().manual_seed(5))
    imgs, lab3, _ = cs.irn_train_batch(22, cs.BATCH, crop, 21,
                                       tr.path_index)
    xn = _normalizer(adp.norm_irn, dev)(
        torch.from_numpy(imgs).to(dev, torch.float32))
    lab3 = [torch.from_numpy(a).to(dev) for a in lab3]

    def steps(n):
        for _ in range(n):
            tr.train_step(xn, *lab3)
        torch.cuda.synchronize()

    steps(3)
    t0 = time.perf_counter()
    steps(STEPS)
    wall = (time.perf_counter() - t0) / STEPS * 1e3
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        steps(STEPS)
    ev = prof.key_averages()
    dev_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    cpu_ev = [e for e in ev if e.device_type == torch.autograd.DeviceType.CPU
              and e.key.startswith('aten::')]
    busy = sum(e.self_device_time_total for e in dev_ev) / STEPS / 1e3
    n_dev = sum(e.count for e in dev_ev) / STEPS
    n_aten = sum(e.count for e in cpu_ev) / STEPS
    print(f'PROF {tree} wall {wall:.2f} ms a step, device busy {busy:.2f} '
          f'ms, {n_dev:.0f} device events, {n_aten:.0f} aten calls a step '
          f'({smi})', flush=True)
    top = sorted(cpu_ev, key=lambda e: -e.count)[:12]
    print(f'PROF {tree} aten calls a step: ' + ', '.join(
        f'{e.key[6:]} {e.count / STEPS:.0f}' for e in top), flush=True)
    pr = cProfile.Profile()
    pr.enable()
    steps(STEPS)
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats('tottime').print_stats(15)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if 'tottime' in ln)
    for ln in lines[start:start + 16]:
        print(f'PROF {tree} cprofile {ln.strip()}', flush=True)


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--one':
        one_tree(sys.argv[2])
    else:
        for t in sys.argv[1:]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', t], check=True)
