"""Nothing a run loads, and nothing of the reference, is JAX or the JAX
package (top-level names compared whole: world_tpu_torch is not
world_tpu); the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "world_tpu"}


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r})\n{code}\nprint('MODULES', sorted({{m.split('.')[0]"
         f" for m in sys.modules}}))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("MODULES")]
    return set(eval(line[-1][len("MODULES "):]))


def test_a_run_loads_no_jax():
    names = [m["name"] for k in ("end_to_end", "per_layer")
             for m in json.loads((ROOT / "BENCHMARK.json").read_text())[k]]
    mods = loaded_after(
        "import torch; torch.set_num_threads(2)\n"
        "from portbench import run, control\n"
        f"[run.reader(n) for n in {names!r}]\n"
        "from portbench.tests.test_portbench_check import tiny\n"
        "run.run_cell('dio_48k.features', 3, 0.5, False, device='cpu',"
        " cell=tiny('dio_48k.features'))\n"
        "assert run.forbidden_modules() == []")
    assert not mods & JAX_NAMES
    assert "world_tpu_torch" in mods


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = loaded_after("import portbench.reference.analysis\n"
                        "import portbench.check, portbench.work")
    assert not mods & (JAX_NAMES | {"world_tpu_torch"})


def test_no_source_of_the_reference_imports_them():
    for path in (PB / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & (JAX_NAMES | {"world_tpu_torch"}), path
