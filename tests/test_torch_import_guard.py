"""The port, chip_smoke.py and the port's tools import nothing of JAX, of
the JAX package, of ml_dtypes, msgpack, grain or tensorflow: the machine with
the card has none of them (the port reads bf16 as uint16 bits, flax's
msgpack through its own codec, and grain's order through torch's
DataLoader).  The port builds its C++ reader from its own copy of the
sources, never from the repo root's ``native/``.  The one tool that writes a TF checkpoint fixture imports tensorflow
inside its writer; it runs where tensorflow is installed."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "learnablepoolingmethods_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "absl", "learnablepoolingmethods_tpu", "tensorflow",
          "ml_dtypes", "msgpack", "grain")
# scripts that may import tensorflow (inside a function, never at import)
TF_WRITERS = ("torch_make_tf_bundle_fixture.py",)
SCRIPTS = [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py"))


def _sources():
    return sorted(PORT.rglob("*.py")) + SCRIPTS


def _module_names():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, importlib.util, sys\n"
        f"for name in {_module_names() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        f"for path in {[str(p) for p in SCRIPTS[1:]]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('tool', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})\n"
        "print('BAD', bad)\n"
        "print('BUILT', sys.modules['learnablepoolingmethods_torch.data.native_loader']._lib)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "BUILT None" in out.stdout, out.stdout  # nothing loads the C++ reader at import


def test_the_guard_covers_the_kernel_modules():
    """Every kernel wrapper and fast path of the port is among the modules
    that the guard imports, down to the newest ones."""
    names = _module_names()
    for module in ("fast_infer", "fast_lf", "fast_dispatch", "fused_frontend", "netvlad_fused",
                   "netvlad_train", "netfv_fused", "softdbow_fused", "kernel_build", "fast_transformer",
                   "masked_attention", "fast_dbof", "metrics_ops", "fused_adam", "int8_matmul", "dropout",
                   "native_tail"):
        assert f"learnablepoolingmethods_torch.ops.{module}" in names, module
    for module in ("models.frame_level", "models.video_level", "models.attention", "eval", "inference", "train", "losses",
                   "core.observability", "core.step", "core.optimizers", "core.checkpoints",
                   "core.checkpoint_import", "core.train_state", "utils.tf_bundle", "data.readers",
                   "data.fixtures", "export_model", "serving", "utils.flax_msgpack", "data.native_loader",
                   "data.packed_cache", "data.grain_pipeline", "data.pipeline", "cli_flags", "parallel",
                   "parallel.mesh", "parallel.collectives", "core.native_runtime"):
        assert f"learnablepoolingmethods_torch.{module}" in names, module


def test_port_sources_import_no_jax():
    offenders = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {m}" for m in mods if m.split(".")[0] in BANNED
                          and not (path.name in TF_WRITERS and m.split(".")[0] == "tensorflow")]
    assert not offenders, offenders


def _path_parts(path):
    """The string constants that ``path``'s code builds a path from: the
    operands of a ``/`` and the arguments of a ``join``."""
    parts = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            parts += [node.left, node.right]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) == "join":
            parts += node.args
    return [n.value for n in parts if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def test_the_port_builds_its_own_copy_of_the_native_sources():
    """The C++ reader's sources are the port's (``learnablepoolingmethods_torch/
    native``): the one path to a ``native`` directory in the port's code is
    native_loader's, inside the package, and nothing names the repo root's
    sources or library."""
    from learnablepoolingmethods_torch.data import native_loader

    assert native_loader.NATIVE_DIR == PORT / "native"
    assert all((PORT / "native" / name).is_file() for name in native_loader.SOURCES)
    assert native_loader.BUILD_DIR == ROOT / "build" / "host"
    offenders = []
    for path in _sources():
        for value in _path_parts(path):
            if (value.startswith("native") and path.name != "native_loader.py") or "libtfrecord_reader.so" in value:
                offenders.append(f"{path.relative_to(ROOT)}: {value!r}")
    assert not offenders, offenders
