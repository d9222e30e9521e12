"""Nothing on the main path imports TPU-only Pallas or flax."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "ai_safety_gridworlds_tpu")


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    for name in ("chip_smoke.py", "bench.py", "__graft_entry__.py"):
        yield os.path.join(REPO, name)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


@pytest.mark.parametrize(
    "path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_tpu_pallas_or_flax_import(path):
    for mod in _imported_modules(path):
        assert not mod.startswith("jax.experimental.pallas.tpu"), mod
        assert not mod.startswith("flax"), mod


def test_main_path_loads_without_flax_or_tpu_pallas():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from ai_safety_gridworlds_tpu import ops\n"
        "from ai_safety_gridworlds_tpu.helpers import batched\n"
        "from ai_safety_gridworlds_tpu.learners import ppo_fused\n"
        "from ai_safety_gridworlds_tpu.ops import reference_chain\n"
        "for name in ('FusedFiremaker', 'FusedSavanna', 'FusedIslandMa',\n"
        "             'FusedBoatRace'):\n"
        "    getattr(ops, name)\n"
        "bad = [m for m in sys.modules if m.startswith('flax')\n"
        "       or m.startswith('jax.experimental.pallas.tpu')\n"
        "       or m.startswith('jax._src.pallas.mosaic.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, check=True,
        timeout=300,
    )
