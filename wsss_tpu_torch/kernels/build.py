"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, ints and the
stream as ``void*``; every entry returns ``cudaGetLastError()``) and
compiles on its own into ``_build/<name>-<hash>.so`` inside this package
directory (listed in ``.gitignore``), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The hash covers the source and the flags, so an edited source rebuilds.
All sources build in parallel, one nvcc process each, at first use;
nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = pathlib.Path(__file__).resolve().parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, object] = {}
BUILD_LOG: Dict[str, str] = {}      # name -> nvcc's stderr (ptxas -v)


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        cands.append(found)
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError('nvcc not found: the CUDA kernels of wsss_tpu_torch '
                       'build only where the CUDA toolkit is installed')


def sources() -> Dict[str, pathlib.Path]:
    return {p.stem: p for p in sorted(CSRC.glob('*.cu'))}


def _target(src: pathlib.Path, flags) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes() + ' '.join(flags).encode())
    return BUILD_DIR / f'{src.stem}-{h.hexdigest()[:16]}.so'


def build(verbose: bool = False) -> float:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together, and load all libraries.  verbose adds
    ``-Xptxas -v`` (registers, shared memory, spills land in BUILD_LOG).
    Returns the seconds spent.  Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    flags = NVCC_FLAGS + (('-Xptxas', '-v') if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources().items():
        so = _target(src, flags)
        if so.exists():
            continue
        tmp = so.with_suffix(f'.{os.getpid()}.tmp')
        procs[name] = (so, tmp, subprocess.Popen(
            [nvcc_path(), *flags, '-o', str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (so, tmp, proc) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[name] = (out + err).strip()
        if proc.returncode != 0:
            errors.append(f'{name}: nvcc exit {proc.returncode}\n{out}{err}')
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(errors))
    for name, src in sources().items():
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(src, flags)))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all on first use."""
    if name not in _LIBS:
        build()
    return _LIBS[name]


def entry(name: str, argtypes):
    """The C entry ``name`` of csrc/<name>.cu with its ctypes signature
    set (pointers as c_void_p, so none is cut to 32 bits) and an int
    return."""
    if name not in _ENTRIES:
        f = getattr(library(name), name)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _ENTRIES[name] = f
    return _ENTRIES[name]
