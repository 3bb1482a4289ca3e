"""Nothing the benchmark runs may load JAX or the JAX package, compared
by whole top-level module names; the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from portbench import harness

REFERENCE = os.path.join(harness.ROOT, 'portbench', 'reference')


def test_forbidden_names_are_whole_top_level_names():
    # the port's name begins with the JAX package's: no prefix matches
    assert harness.forbidden_loaded(
        ['keypointfusion_torch', 'keypointfusion_torch.serving',
         'jaxtyping', 'flaxen', 'keypointfusion_tpu_extra', 'torch']) == []
    assert harness.forbidden_loaded(
        ['jax.numpy', 'jaxlib.xla_client', 'keypointfusion_tpu.models',
         'optax', 'orbax.checkpoint', 'flax.linen']) == [
        'flax', 'jax', 'jaxlib', 'keypointfusion_tpu', 'optax', 'orbax']


def test_reference_sources_import_nothing_of_the_program():
    for name in os.listdir(REFERENCE):
        if not name.endswith('.py'):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ''] if isinstance(node, ast.ImportFrom) \
                else []
            for m in mods:
                top = m.split('.')[0]
                assert top not in ('keypointfusion_torch',) \
                    + harness.FORBIDDEN, (name, m)


def test_a_run_loads_no_jax():
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'from portbench.tests.helpers import run_small, EVAL\n'
        'run_small(EVAL, seconds=0.1)\n'
        'from portbench import harness\n'
        'print(harness.forbidden_loaded())\n'
        'import portbench.reference.model, portbench.reference.train\n'
        'print(sorted(m for m in sys.modules if m.startswith("portbench")))'
        % harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, 'JAX_PLATFORMS': 'cpu'})
    assert out.stdout.splitlines()[0] == '[]'


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import portbench.reference.model, portbench.reference.train\n'
            'import portbench.reference.preprocess\n'
            'print(sorted({m.split(".")[0] for m in sys.modules} & '
            '{"keypointfusion_torch", "keypointfusion_tpu", "jax"}))'
            % harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == '[]'
