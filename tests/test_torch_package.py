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
                            ROOT / 'scripts' / 'profile_torch_hsn.py',
                            ROOT / 'scripts' / 'time_clis.py'],
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
        'bilateral_slice_aligned', 'flat_color_blur', 'direct_window'}
    assert sorted(build.sources()) == sorted(bilateral.LAUNCHES)


def test_verbose_build_is_the_build_later_calls_load(tmp_path, monkeypatch):
    """build(verbose=True) (chip_smoke.py's) adds -Xptxas -v, which only
    logs: the libraries it writes are the ones a later build() finds, so
    nothing compiles twice (nvcc faked: there is none here)."""
    from wsss_tpu_torch.kernels import build
    calls = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, argv, **kw):
            calls.append(argv)
            open(argv[argv.index('-o') + 1], 'w').close()

        def communicate(self):
            return '', 'ptxas info'

    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, 'nvcc_path', lambda: 'nvcc')
    monkeypatch.setattr(build.subprocess, 'Popen', FakeNvcc)
    monkeypatch.setattr(build.ctypes, 'CDLL', str)
    monkeypatch.setattr(build, '_LIBS', {})
    build.build(verbose=True)
    assert len(calls) == len(build.sources())
    assert all('-v' in argv for argv in calls)
    loaded = dict(build._LIBS)
    monkeypatch.setattr(build, '_LIBS', {})
    build.build()
    assert len(calls) == len(build.sources()) and build._LIBS == loaded


def test_entry_points_default_to_cuda(tmp_path):
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
    from wsss_tpu_torch.train.sec_dsrg import (SECDSRGPredictor,
                                               SECDSRGTrainer)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        SECDSRGPredictor('SEC', 3)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        SECDSRGTrainer('DSRG', 3)
    from wsss_tpu_torch.models.backbones import build_classifier
    from wsss_tpu_torch.train.classifier import ClassifierTrainer
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ClassifierTrainer(build_classifier('M7', 3))
    from wsss_tpu_torch.methods.gradcam_cues import (
        ADPCueGenerator, VOCDeepGlobeCueGenerator)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        VOCDeepGlobeCueGenerator(registry.get('DeepGlobe'), fg)
    adp = _ClassifierHandle.random('M7', 31, 16, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ADPCueGenerator(adp, 'M7')
    from wsss_tpu_torch.methods import irnet
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        irnet.CAMInference(fg, registry.get('DeepGlobe'), 'M7')
    cam = {'keys': np.array([1]), 'cam': np.ones((1, 4, 4), np.float32),
           'high_res': np.ones((1, 16, 16), np.float32)}
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        irnet.cam_to_ir_label(np.zeros((16, 16, 3), np.float32), cam,
                              'VOC2012', 0.5)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        irnet.make_sem_seg(torch.zeros(4, 4), cam, 'VOC2012', (16, 16))
    import argparse
    from wsss_tpu_torch.cli import common, gen_cues, irn
    args = common.add_common_args(argparse.ArgumentParser()).parse_args(
        ['--dataset', 'DeepGlobe', '--model', 'M7', '--img_size', '16'])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        common.load_handle(args, 6, 16)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        gen_cues.main(['--dataset', 'DeepGlobe', '--model', 'M7',
                       '--img_size', '16', '--synthetic_n', '2'])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        irn.main(['--dataset', 'DeepGlobe', '--model', 'M7', '--img_size',
                  '16', '--synthetic_n', '2', '--passes', 'make_cam',
                  '--work_root', str(tmp_path)])
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        irnet.IRNTrainer('m7', crop_size=32)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        irn.main(['--dataset', 'DeepGlobe', '--model', 'M7', '--img_size',
                  '32', '--synthetic_n', '2', '--batchsize', '2',
                  '--passes', 'train_irn', '--work_root', str(tmp_path)])
    from wsss_tpu_torch.cli import parity
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        parity.main(['--datasets', 'DeepGlobe', '--models', 'alt',
                     '--img_size', '16', '--synthetic_n', '2',
                     '--eval_root', str(tmp_path / 'eval')])


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


def test_split_files_are_byte_copies():
    """The port ships its own copy of the reference's split lists and
    reads no file of the JAX package."""
    ours = PORT / 'data' / 'splits'
    ref = ROOT / 'wsss_tpu' / 'data' / 'splits'
    names = sorted(p.relative_to(ref) for p in ref.rglob('*.txt'))
    assert names and names == sorted(p.relative_to(ours)
                                     for p in ours.rglob('*.txt'))
    for n in names:
        assert (ours / n).read_bytes() == (ref / n).read_bytes(), n
    from wsss_tpu_torch.data.pipeline import packaged_split_path
    path = pathlib.Path(packaged_split_path('ADP-morph', 'segtest'))
    assert path == ours / 'adp' / 'evaluation.txt'
    assert packaged_split_path('VOC2012', 'nonexistent') is None
