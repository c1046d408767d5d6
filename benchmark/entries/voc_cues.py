"""VOC2012 cue generation (02_cues): ``VOCDeepGlobeCueGenerator.run`` on
one host batch of uint8 images and tags a call, out to the pickle dict
(a closed loop, one client, as ``cli.gen_cues`` runs a split).

Kept for the check: each sampled call's fg and bg seed CAMs (what the
generator's per-network step returned) and its packed cues.  The
reference recomputes both from the same images, tags and weights."""
from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.harness import traffic as T
from benchmark.harness.checks import max_gap
from benchmark.harness.entry import EntryBase, classifier_handles
from benchmark.reference import cues as ref_cues
from benchmark.reference.numerics import Numerics


def cue_set(packed: dict, idx: int) -> set:
    return {tuple(v) for v in np.asarray(packed[f'{idx}_cues']).T}


class Entry(EntryBase):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 ranges):
        from wsss_tpu_torch.data import registry
        from wsss_tpu_torch.methods import gradcam_cues as gc

        super().__init__(cfg, traffic, seed, device)
        c = cfg['cues']
        self.tags = T.image_tags(seed, traffic, traffic['pool'],
                                 cfg['networks']['fg'])
        self.layers, handles = classifier_handles(
            cfg, seed, device, ranges, c['class_threshold'])
        self.program = gc.VOCDeepGlobeCueGenerator(
            registry.get(cfg['dataset']), *handles, thresh=c['threshold'],
            seed_size=c['seed_size'], device=device)
        self._cams = []
        ranges.wrap(self.program, '_run_net', 'cues.run_net', self._observe)
        self.warm_up()

    def _observe(self, args, kwargs, out):
        if self.keeping():
            self._cams.append(out[0])

    def inputs(self, i: int):
        picks = self.order[i % len(self.order)]
        b = picks.shape[0]
        return types.SimpleNamespace(
            images=T.gather(self.pool, picks), tags=self.tags[picks[:, 1]],
            indices=list(range(max(i, 0) * b, max(i, 0) * b + b)))

    def call(self, i: int, batch) -> int:
        self._i, self._cams = i, []
        out = self.program.run([batch])
        if self.keeping():
            self.kept[i] = {'fg': self._cams[0], 'bg': self._cams[1],
                            'cues': out}
        return len(batch.indices)

    def reference_outputs(self, mode: str):
        out = {}
        with Numerics(mode, self.device) as num:
            ref = ref_cues.CueReference(num, self.cfg, self.layers['fg'],
                                        self.layers['bg'])
            for i in sorted(self.kept):
                b = self.inputs(i)
                out[i] = ref.run(
                    torch.as_tensor(b.images).to(self.device).float(),
                    torch.as_tensor(b.tags, device=self.device), b.indices)
        return out

    def gaps(self, got: dict, ref: dict) -> dict:
        """cam_gap: the seed CAMs' widest gap over their scale; cue_gap:
        the share of seed pixels whose cue differs (an image whose
        passing classes differ counts whole)."""
        g = self.cfg['cues']['seed_size']
        bad = total = 0
        for i in ref:
            for idx in self.inputs(i).indices:
                total += g * g
                a, r = got[i]['cues'], ref[i]['cues']
                if not np.array_equal(a[f'{idx}_labels'],
                                      r[f'{idx}_labels']):
                    bad += g * g
                    continue
                diff = cue_set(a, idx) ^ cue_set(r, idx)
                bad += len({(y, x) for _, y, x in diff})
        return {'cam_gap': max(max_gap(got[i][k], ref[i][k])
                               for i in ref for k in ('fg', 'bg')),
                'cue_gap': bad / total}
