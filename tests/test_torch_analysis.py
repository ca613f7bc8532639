"""The port's analyzers and chaos engine stand alone: no JAX, no reference.

- An AST scan of every module under ``heat_tpu_torch/``: none imports
  ``jax`` or ``heat_tpu``, and none names a path under ``heat_tpu/`` or
  ``scripts/`` outside a docstring (a module the port needs from there has
  its own copy, loaded from the port's tree).  The scan is held to catch
  each way of naming such a path.
- ``analysis/postmortem.py``, ``analysis/timeline.py`` and
  ``chaos/engine.py`` load by path and work in a process where ``torch``
  cannot be imported, as a supervising host or a login node runs them.
"""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
_PATH = re.compile(r"(^|[\s'\"/(])(heat_tpu|scripts)(/|$)")


def _docstrings(tree) -> set:
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                ids.add(id(first.value))
    return ids


def offences(source: str) -> list:
    """(line, what) of each import of jax or heat_tpu and each string
    naming a path under heat_tpu/ or scripts/ (docstrings aside)."""
    tree = ast.parse(source)
    docs, out = _docstrings(tree), []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        out += [(node.lineno, f"imports {n}") for n in names if n.split(".")[0] in ("jax", "jaxlib", "heat_tpu")]
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            if node.value in ("heat_tpu", "scripts") or _PATH.search(node.value):
                out.append((node.lineno, f"names {node.value[:80]!r}"))
    return out


def test_no_port_module_imports_the_reference_or_names_its_paths():
    files = sorted((REPO / "heat_tpu_torch").rglob("*.py"))
    assert len(files) > 100
    found = {str(f.relative_to(REPO)): offences(f.read_text()) for f in files}
    assert not {f: o for f, o in found.items() if o}, found


@pytest.mark.parametrize("source", [
    "import jax\n",
    "from heat_tpu.utils import faults\n",
    "import os\np = os.path.join(ROOT, 'heat_tpu', 'utils', 'faults.py')\n",
    "p = 'scripts/postmortem.py'\n",
    "p = ROOT + '/heat_tpu/analysis/timeline.py'\n",
    "p = f'{ROOT}/scripts/chaoscamp.py'\n",
])
def test_the_scan_catches(source):
    assert offences(source), source


@pytest.mark.parametrize("source", [
    '"""Replaces ``heat_tpu/ops/flash_attention.py``."""\n',
    "p = 'heat_tpu_torch/analysis/postmortem.py'\n",
    "import heat_tpu_torch.utils\n",
])
def test_the_scan_passes(source):
    assert not offences(source), source


_STANDALONE = r"""
import importlib.util, json, os, sys, tempfile
sys.modules["torch"] = None  # import torch now raises
pkg = sys.argv[1]

def load(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod

pm = load("pm_alone", "analysis/postmortem.py")
tl = load("tl_alone", "analysis/timeline.py")
eng = load("engine_alone", "chaos/engine.py")
fr = pm._flightrec_mod()
d = tempfile.mkdtemp()
for rank, n in ((0, 6), (1, 2)):
    r = fr.FlightRecorder(os.path.join(d, "flight_rank%d.ring" % rank), slots=64, rank=rank)
    for _ in range(n):
        r.record_collective("Allreduce", 100)
    r.close()
v = pm.analyze_dir(d, expected_ranks=[0, 1])
bundle = tl.assemble([d])
trace = tl.to_chrome_trace(bundle)
row = {"index": 0, "seed": 1, "digest": "x", "workload": "train", "ranks": 1, "jobs": 6, "faults": [], "ok": True,
       "fails": []}
print(json.dumps({"verdict": v["verdict"], "rank": v["straggler"]["rank"], "lag": v["straggler"]["lag"],
                  "line": pm.summary_line(v), "trace_ok": tl.validate_chrome_trace(trace) == [],
                  "ranks": sorted(bundle["ranks"]), "table": eng.verdict_table([row]).splitlines()[-1],
                  "torch": "torch" in sys.modules and sys.modules["torch"] is not None}))
"""


def test_analyzers_and_engine_load_by_path_without_torch():
    out = subprocess.run([sys.executable, "-c", _STANDALONE, str(REPO / "heat_tpu_torch")], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["verdict"] == "straggler" and got["rank"] == 1 and got["lag"] == 4, got
    assert got["line"].startswith("POSTMORTEM verdict=straggler rank=1 seq=2"), got
    assert got["trace_ok"] and got["ranks"] == [0, 1]
    assert got["table"].startswith("CHAOS-CAMPAIGN schedules=1 ok=1 fail=0"), got
    assert not got["torch"]
