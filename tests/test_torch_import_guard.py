"""The port, chip_smoke.py and the port's tools import nothing of JAX or of
the JAX package: the machine with the card has neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "learnablepoolingmethods_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "absl", "learnablepoolingmethods_tpu")
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
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


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
            offenders += [f"{path.name}:{node.lineno} {m}" for m in mods if m.split(".")[0] in BANNED]
    assert not offenders, offenders
