"""The benchmark's CPU tests import it as the package ``benchmark`` from
the root of the checkout."""
import json
import os
import pathlib
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import pytest  # noqa: E402

SIZES = pathlib.Path(__file__).resolve().parent / 'cpu_sizes'


class MissingSize(LookupError):
    """A cell of ``BENCHMARK.json`` that has no CPU size file."""


class CpuSizes(dict):
    """Each cell at a size the CPU holds: the published widths, small
    images and batches (the grid CRF needs more than 10 240 pixels an
    image).  ``<directory>/<cell>.json`` holds ``{"config": {...},
    "traffic": {...}}``: the keys of the cell's configuration and traffic
    files that the CPU tests replace (``runner.run``'s ``overrides``).  A
    file a cell, so that a cell comes in by new files alone."""

    def __init__(self, directory: pathlib.Path = SIZES):
        self.directory = pathlib.Path(directory)
        super().__init__((p.stem, json.loads(p.read_text()))
                         for p in sorted(self.directory.glob('*.json')))

    def __missing__(self, cell: str):
        where = self.directory.relative_to(self.directory.parents[2])
        raise MissingSize(
            f'cell {cell!r} has no CPU test size: add {where}/{cell}.json, '
            'the keys of its configuration and traffic files to replace, '
            'as {"config": {...}, "traffic": {...}}')


TINY = CpuSizes()


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA card; skips without one')


@pytest.fixture
def torch_threads():
    """Few intra-op threads: the suite runs in several workers."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
