"""What the benchmark's modules load: never JAX nor the JAX package, and
the reference never the port.

Module names are compared by their whole top-level name (the part before
the first dot): rene_tpu_torch, the port, begins with rene_tpu, the JAX
package, and is not it. Each check imports the modules in a fresh
interpreter and reads its sys.modules.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def modules(folder: Path):
    """Dotted names of the modules under `folder`, the tests left out."""
    out = []
    for p in sorted(folder.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or p.name == "__init__.py" \
                or "metrics" in rel.parts or "." in p.stem:
            continue
        out.append(".".join(rel.parts))
    return out


def loaded_top_names(names, extra=""):
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        f"{extra}"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    extra = ("import importlib.util, pathlib\n"
             "for p in sorted(pathlib.Path('port_bench/metrics')"
             ".glob('*.py')):\n"
             "    s = importlib.util.spec_from_file_location("
             "'m_' + p.stem.replace('.', '_'), p)\n"
             "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    names = modules(BENCH)
    assert "port_bench.harness" in names and "port_bench.check" in names
    top = loaded_top_names(names, extra)
    assert not top & {"jax", "jaxlib", "flax", "rene_tpu"}, top


def test_reference_reaches_nothing_of_the_port():
    names = modules(BENCH / "reference") + modules(BENCH / "scenes")
    assert "port_bench.reference.render" in names
    assert "port_bench.reference.rt.integrators.volpath" in names
    top = loaded_top_names(names)
    assert not top & {"jax", "jaxlib", "flax", "rene_tpu",
                      "rene_tpu_torch"}, top


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from port_bench import harness
    monkeypatch.setitem(sys.modules, "rene_tpu_torch_like", sys)
    assert "rene_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rene_tpu.render", sys)
    assert harness.forbidden_modules() == ["rene_tpu"]
