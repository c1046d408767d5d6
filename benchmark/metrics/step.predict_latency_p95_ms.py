"""step.predict_latency_p95_ms: the 95th percentile of one call's host
time (host input handed in to labels on the host) over the traced
window's calls, in ms.  Layer: the entry step.

``sec_predict_voc``'s tail: its runs spread too widely, from the host's
speed, for any end-to-end bound the contract allows (PERF.md section 2),
so it stands here beside ``predict_img_per_s``.  The profiler adds host
time to each launch, so it reads above an untraced run's tail."""
from benchmark.harness.runner import p95


def read(view, run):
    lat = run.get('latency_s')
    if not lat:
        return None
    return 1e3 * p95(lat)
