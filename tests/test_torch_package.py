"""The port stands alone: it imports nothing of JAX or of ``depthvo_tpu``;
and it has every public name of the reference, bar an allow-list."""

import ast
import json
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


def test_parallel_and_feature_pretraining_stand_alone():
    """The data-parallel modules and feature pretraining import no JAX,
    flax, optax, orbax or ``depthvo_tpu``, and the source scan above
    covers their files."""
    modules = ["depthvo_tpu_torch.parallel", "depthvo_tpu_torch.parallel.mesh",
               "depthvo_tpu_torch.parallel.distributed", "depthvo_tpu_torch.train.feat_pretrain"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(_BANNED)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    port = _REPO / "depthvo_tpu_torch"
    files = {p.relative_to(port).as_posix() for p in port.rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/distributed.py",
            "train/feat_pretrain.py"} <= files


# Reference names the port leaves out on purpose, each with its reason.
_NOT_PORTED = {
    "ops.warp_pallas": ("*", "the Pallas kernels; the port's are CUDA kernels in "
                             "ops/csrc/warp.cu behind ops/warp_kernels.py"),
    "parallel": ({"batch_sharding", "replicated"},
                 "JAX NamedShardings: a rank holds its rows (shard_batch) and a replica "
                 "of the state (mesh.replicate), no sharding object"),
    "parallel.mesh": ({"batch_sharding", "replicated"}, "as for parallel"),
    "models.layers": ({"space_to_depth2", "s2d_conv_kernel", "s2d_upconv_kernel",
                       "tile_phase_bias", "Dtype"},
                      "the s2d rewrite of the finest stage for the TPU's matrix unit: the "
                      "port computes s2d_finest with the standard stage, the same function "
                      "(models/depth_net.py)"),
}


def _public_names(path: pathlib.Path) -> list:
    """A reference module's public top-level names: its functions, classes
    and assigned names, and in an ``__init__`` the names it imports; the
    root package's lazy names (``_API_NAMES`` and ``zoo``) too."""
    tree = ast.parse(path.read_text(), str(path))
    init = path.name == "__init__.py"
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
            if init and any(getattr(t, "id", "") == "_API_NAMES" for t in node.targets):
                names += list(ast.literal_eval(node.value)) + ["zoo"]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
        elif init and isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return sorted({n for n in names if not n.startswith("_")})


def test_every_public_name_of_the_reference_exists_in_the_port():
    """The reference's modules walked with ``ast`` (nothing of JAX is
    imported for it); each name is looked up in the port's counterpart
    module by a process that imports the port alone, which must leave JAX
    out of ``sys.modules``. What is missing must be exactly the
    allow-list above."""
    ref = _REPO / "depthvo_tpu"
    wanted = {}
    for path in sorted(ref.rglob("*.py")):
        parts = path.relative_to(ref).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        wanted[".".join(parts)] = _public_names(path)
    assert len(wanted) > 40 and "predict_depth" in wanted[""]
    code = (
        "import importlib, json, sys\n"
        f"wanted = {json.dumps(wanted)}\n"
        "missing = {}\n"
        "for rel, names in wanted.items():\n"
        "    name = 'depthvo_tpu_torch' + ('.' + rel if rel else '')\n"
        "    try:\n"
        "        mod = importlib.import_module(name)\n"
        "    except ModuleNotFoundError as e:\n"
        "        if e.name != name:\n"
        "            raise\n"
        "        missing[rel] = '*'\n"
        "        continue\n"
        "    gone = sorted(n for n in names if not hasattr(mod, n))\n"
        "    if gone:\n"
        "        missing[rel] = gone\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(_BANNED)!r})\n"
        "print(json.dumps({'missing': missing, 'banned': bad}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["banned"] == []
    allowed = {rel: names if names == "*" else sorted(names)
               for rel, (names, _reason) in _NOT_PORTED.items()}
    assert out["missing"] == allowed


def test_root_names_resolve_lazily_without_jax():
    code = (
        "import sys\n"
        "import depthvo_tpu_torch as d\n"
        "assert 'depthvo_tpu_torch.api' not in sys.modules, 'the root import built the API'\n"
        "from depthvo_tpu_torch import api, zoo\n"
        "assert d.DepthVO is api.DepthVO and d.predict_depth is api.predict_depth\n"
        "assert d.predict_pose is api.predict_pose and d.load_model is api.load_model\n"
        "assert d.zoo is zoo and hasattr(d.zoo, 'ZOO')\n"
        "try:\n"
        "    d.no_such_name\n"
        "except AttributeError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('an unknown name resolved')\n"
        "import depthvo_tpu_torch.train as t, depthvo_tpu_torch.train.loop as loop\n"
        "assert t.fit is loop.fit and t.make_train_step is loop.make_train_step\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(_BANNED)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
