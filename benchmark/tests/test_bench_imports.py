"""A dry import of benchmark/run.py and everything a run loads, in a fresh
process, leaves no module whose top-level name is jax, jaxlib, flax or
tinaural (compared whole: tinaural_torch is the program and allowed)."""

import json
import subprocess
import sys

from benchmark.harness import spec
from benchmark.harness.runner import FORBIDDEN, forbidden_modules

PROBE = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("bench_run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
run.load_all()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_dry_import_loads_no_jax():
    code = PROBE.format(root=str(spec.ROOT),
                        run=str(spec.BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tinaural_torch" in top and "benchmark" in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tinaural_torchx", sys)
    assert "tinaural" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "tinaural.models", sys)
    assert "tinaural" in forbidden_modules()
