"""No module of the benchmark imports JAX, its libraries or the JAX
package, and no reference module imports the program: each import's
top-level name, compared whole."""
import ast
import pathlib

import pytest

from benchmark.harness import guards

BENCH = pathlib.Path(__file__).resolve().parents[1]


def top_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield guards.top_name(a.name)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield guards.top_name(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'id', getattr(node.func, 'attr', ''))
              in ('import_module', '__import__') and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield guards.top_name(str(node.args[0].value))


SOURCES = sorted(BENCH.rglob('*.py'))


@pytest.mark.parametrize('path', SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    bad = set(top_imports(path)) & set(guards.FORBIDDEN)
    assert not bad, f'{path} imports {bad}'


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert 'wsss_tpu_torch' not in set(top_imports(path))


def test_names_are_compared_whole():
    assert guards.forbidden_loaded(['wsss_tpu_torch.ops', 'jaxtyping',
                                    'flaxen', 'numpy']) == []
    assert guards.forbidden_loaded(['jax.numpy', 'wsss_tpu.ops', 'flax']) \
        == ['flax', 'jax.numpy', 'wsss_tpu.ops']


def test_the_scan_sees_a_jax_import(tmp_path):
    f = tmp_path / 'm.py'
    f.write_text('import os\nfrom jax import numpy\n'
                 'import wsss_tpu_torch.ops\n')
    assert set(top_imports(f)) == {'os', 'jax', 'wsss_tpu_torch'}
