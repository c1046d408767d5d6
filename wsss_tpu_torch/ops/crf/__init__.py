from wsss_tpu_torch.ops.crf.config import CRFConfig, hsn_config  # noqa: F401
from wsss_tpu_torch.ops.crf.meanfield import (  # noqa: F401
    crf_label_refine, mean_field)
from wsss_tpu_torch.ops.crf.mxu_grid import (  # noqa: F401
    MXUBilateralGrid)
from wsss_tpu_torch.ops.crf.mxu_sharded import (  # noqa: F401
    mean_field_sharded as mean_field_sharded_grid)
from wsss_tpu_torch.ops.crf.sharded import mean_field_sharded  # noqa: F401
