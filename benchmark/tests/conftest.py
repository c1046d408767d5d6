"""The benchmark's CPU tests import it as the package ``benchmark`` from
the root of the checkout."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pytest  # noqa: E402

# each cell at a size the CPU holds: the published widths, small images
# and batches (the grid CRF needs more than 10 240 pixels an image)
TINY = {
    'hsn_voc_b8': {
        'config': {'input_size': 104},
        'traffic': {'sizes': [[104, 104]], 'pool': 4, 'batch': 2,
                    'warmup_calls': 1, 'check_calls': 1, 'check_range': 1,
                    'trace_calls': 2}},
    'sec_predict_voc': {
        'config': {'input_size': 97},
        'traffic': {'sizes': [[170, 200], [200, 170]], 'pool': 4,
                    'warmup_calls': 2, 'check_calls': 1, 'check_range': 1,
                    'trace_calls': 2}},
    'cues_voc_b8': {
        'config': {'input_size': 104},
        'traffic': {'sizes': [[104, 104]], 'pool': 4, 'batch': 2,
                    'warmup_calls': 1, 'check_calls': 1, 'check_range': 1,
                    'trace_calls': 2}},
    'sec_train_voc': {
        'config': {'input_size': 65},
        'traffic': {'sizes': [[65, 65]], 'pool': 8, 'batch': 2,
                    'seed_grid': 9, 'trace_calls': 2}},
}


@pytest.fixture
def torch_threads():
    """Few intra-op threads: the suite runs in several workers."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
