"""crf.predict_build_idle_ms:
``crf.build_idle_ms`` of ``sec_predict_voc``, whose end-to-end
metrics are its own (``predict_img_per_s``: one image a call is
host-bound and spreads run to run far more than the other cells)."""
from benchmark.harness import spec

read = spec.metric('crf.build_idle_ms').read
