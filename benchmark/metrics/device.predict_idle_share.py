"""device.predict_idle_share:
``device.idle_share`` of ``sec_predict_voc``, whose end-to-end
metrics are its own (``predict_img_per_s``: one image a call is
host-bound and spreads run to run far more than the other cells)."""
from benchmark.harness import spec

read = spec.metric('device.idle_share').read
