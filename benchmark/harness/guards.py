"""What a run refuses: no card, too few cards, or JAX in the process.

The JAX package beside the port (``wsss_tpu``) is the port's reference in
the CPU tests only; nothing the benchmark runs may load it, nor JAX.
Names are compared whole, by the part before the first dot, so the
port's ``wsss_tpu_torch`` is not ``wsss_tpu``."""
from __future__ import annotations

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'wsss_tpu')


class Refused(Exception):
    """A run that must print no result: the message goes to stderr and
    the process exits non-zero."""


def top_name(module: str) -> str:
    return module.split('.', 1)[0]


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if top_name(m) in FORBIDDEN)


def require_cards(n: int) -> None:
    """Raise Refused unless CUDA is there with at least ``n`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refused('no CUDA device: the benchmark runs on the card only')
    have = torch.cuda.device_count()
    if have < n:
        raise Refused(f'the cell asks for {n} cards, {have} visible')
