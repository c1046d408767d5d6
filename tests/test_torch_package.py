"""The PyTorch port stands alone: it imports neither jax, flax nor the JAX
package, builds nothing at import, and its entry points run on the card
unless the CPU is asked for."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / 'wsss_tpu_torch'


def _port_modules():
    return sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts)
        .replace('.__init__', '')
        for p in PORT.rglob('*.py'))


def test_import_leaves_jax_out():
    code = (
        'import importlib, sys\n'
        f'for m in {_port_modules()!r}:\n'
        '    importlib.import_module(m)\n'
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'wsss_tpu'))\n"
        'assert not bad, bad\n'
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith('ok')


_IMPORT_RE = re.compile(
    r'^\s*(?:from|import)\s+(jax|flax|wsss_tpu)(?:\.|\s|$)', re.M)


@pytest.mark.parametrize('path', sorted(PORT.rglob('*.py'))
                         + [ROOT / 'chip_smoke.py',
                            ROOT / 'scripts' / 'profile_torch_hsn.py'],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert not _IMPORT_RE.findall(path.read_text()), path


def test_kernels_are_not_built_at_import():
    from wsss_tpu_torch.kernels import bilateral, build
    assert not build._LIBS
    assert set(bilateral.LAUNCHES) == {
        'bilateral_splat', 'bilateral_color_blur', 'bilateral_slice',
        'bilateral_splat_tiles', 'bilateral_fold', 'bilateral_fold_blur',
        'bilateral_cube_blur', 'bilateral_splat_aligned',
        'bilateral_slice_aligned', 'flat_color_blur'}
    assert sorted(build.sources()) == sorted(bilateral.LAUNCHES)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    from wsss_tpu_torch.data import registry
    from wsss_tpu_torch.methods.gradcam_cues import _ClassifierHandle
    from wsss_tpu_torch.methods.hsn import HSNSegmenter
    from wsss_tpu_torch.utils.device import resolve_device
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        _ClassifierHandle.random('M7', 6, 16)
    fg = _ClassifierHandle.random('M7', 6, 16, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        HSNSegmenter(registry.get('DeepGlobe'), fg, drop_last_class=True)
    from wsss_tpu_torch.train.sec_dsrg import SECDSRGPredictor
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        SECDSRGPredictor('SEC', 3)


def test_kernel_wrappers_take_cpu_or_cuda_only():
    """A CPU tensor runs the plain version (no build); any other device
    raises instead of falling back."""
    from wsss_tpu_torch.kernels import bilateral as K
    x = torch.ones((1, 8, 8, 2))
    cell = torch.zeros((1, 8, 8), dtype=torch.int32)
    before = dict(K.LAUNCHES)
    grid = K.bilateral_splat(x, cell, 8, 2, 2, 3)
    assert grid.shape == (1, 2, 2, 3, 3, 3, 2)
    np.testing.assert_allclose(float(grid.sum()), 2 * 64, rtol=1e-6)
    assert K.LAUNCHES == before            # the plain version counts none
    with pytest.raises(ValueError, match='no bilateral kernel'):
        K.bilateral_splat(x.to('meta'), cell.to('meta'), 8, 2, 2, 3)
