"""The port stands alone: it imports nothing of JAX or of ``depthvo_tpu``."""

import ast
import os
import pathlib
import subprocess
import sys

_REPO = pathlib.Path(__file__).resolve().parent.parent
_BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "depthvo_tpu"}


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import depthvo_tpu_torch\n"
        "for m in pkgutil.walk_packages(depthvo_tpu_torch.__path__, 'depthvo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(_BANNED)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_port_imports_the_jax_package():
    files = sorted((_REPO / "depthvo_tpu_torch").rglob("*.py"))
    files.append(_REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        bad = set(_imported_roots(path)) & _BANNED
        assert not bad, f"{path.relative_to(_REPO)} imports {sorted(bad)}"


def test_eval_modules_import_neither_pil_nor_matplotlib():
    """The card's machine has neither: the eval path must import them only
    where a call needs them (the odometry figure, ``infer --save-png``,
    the PIL decode fallback)."""
    code = (
        "import sys\n"
        "import depthvo_tpu_torch.eval, depthvo_tpu_torch.eval.runner\n"
        "import depthvo_tpu_torch.eval.resize, depthvo_tpu_torch.data.velodyne\n"
        "import depthvo_tpu_torch.data.eigen, depthvo_tpu_torch.cli\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
