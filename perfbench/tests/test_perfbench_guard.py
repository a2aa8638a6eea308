"""The whole-name check for JAX and the JAX package, and the refusal of a
run without a card or outside a checkout."""

import os
import shutil
import subprocess
import sys

from perfbench.core import spec
from perfbench.core.guard import forbidden_modules


def test_whole_top_level_names():
    found = forbidden_modules({'decompdiff_tpu.x': 1,
                               'decompdiff_tpu_torch.x': 1,
                               'decompdiff_tpu_torch': 1, 'jax': 1,
                               'jaxlib.xla_client': 1, 'flax.linen': 1,
                               'optax': 1, 'jaxtyping': 1, 'numpy': 1})
    assert found == ['decompdiff_tpu.x', 'flax.linen', 'jax',
                     'jaxlib.xla_client', 'optax']


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', **(extra_env or {}))
    return subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload',
         'bond.sample.b100', '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _run(spec.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
    assert 'no CUDA device' in p.stderr


def test_bare_benchmark_directory_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(spec.ROOT / 'perfbench', tmp_path / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = _run(tmp_path, {'PYTHONPATH': ''})
    assert p.returncode != 0
    assert p.stdout.strip() == ''
