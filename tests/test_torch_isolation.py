"""The PyTorch port stands alone: importing every module of
``deepfake_detection_tpu_torch`` and ``chip_smoke`` (without running it)
loads neither ``jax`` nor the JAX package, and no source file of the port
imports the JAX package.

``deepfake_detection_tpu_torch`` begins with the string
``deepfake_detection_tpu``, so every check matches module names exactly,
never by prefix.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "deepfake_detection_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "deepfake_detection_tpu", "tools")

_PROBE = """
import importlib, json, pkgutil, sys
import deepfake_detection_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps({"imported": names,
                  "loaded": sorted(k for k in sys.modules
                                   if k.split(".")[0] in %r)}))
""" % (FORBIDDEN,)


def test_import_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "deepfake_detection_tpu_torch.runners.test" in out["imported"]
    assert "deepfake_detection_tpu_torch.ops.depthwise" in out["imported"]
    assert out["loaded"] == [], out["loaded"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    bad = [f"{p.relative_to(REPO)}:{line} imports {mod}"
           for p in sources for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad
