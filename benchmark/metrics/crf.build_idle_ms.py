"""crf.build_idle_ms: the device's idle time inside the program's
``wsss.crf.build`` spans (the unaries, the guide's downsampling, the
grids and the normalizers before the iterations), per
``wsss.crf.mean_field`` call, in ms.  Layer: the CRF loop."""
from benchmark.harness import spans


def read(view, run):
    return spans.idle_ms_per(view, 'wsss.crf.build', 'wsss.crf.mean_field')
