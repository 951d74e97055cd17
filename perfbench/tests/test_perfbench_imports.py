"""Neither the reference nor a run of the harness loads JAX or the JAX
package, top-level module names compared whole; the reference loads
nothing of the program either."""

import re
import subprocess
import sys
from pathlib import Path

from perfbench import core

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = _loaded_after("import perfbench.reference.model, "
                         "perfbench.reference.control")
    assert "torch" in tops
    assert not tops & {*core.FORBIDDEN_MODULES, "tpu_autoscaler_torch"}


def test_a_run_loads_no_jax():
    tops = _loaded_after(
        "from perfbench.tests import tiny\n"
        "r = tiny.run(tiny.cell('sc2-3b.chat'))\n"
        "assert r['correct'], r\n"
        "from perfbench import core\n"
        "assert core.forbidden_loaded() == []\n")
    assert "tpu_autoscaler_torch" in tops
    assert not tops & set(core.FORBIDDEN_MODULES)


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                         r"tpu_autoscaler)(\s|\.|$)", re.M)
    for path in HERE.rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_autoscaler_torch_x", sys)
    assert core.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert core.forbidden_loaded() == ["jax"]
