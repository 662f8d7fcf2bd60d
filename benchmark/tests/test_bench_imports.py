"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``radish_pt_tpu`` (compared whole: the port,
``radish_pt_tpu_torch``, begins with the JAX package's name), and the
reference imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import tiny  # noqa: F401  (puts the benchmark on the path)
from harness import main as hmain

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    return out.stdout.strip().splitlines()[-1]


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("radish_pt_tpu", None)
        sys.modules["radish_pt_tpu_torch_fake"] = sys
        assert "radish_pt_tpu" not in hmain.forbidden_modules()
        sys.modules["radish_pt_tpu.scene"] = sys
        assert "radish_pt_tpu" in hmain.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.join(BENCH, 'tests')!r}]\n"
            "import tiny\n"
            "out = tiny.run('cornell.restir', seconds=0.3)\n"
            "from harness.main import forbidden_modules\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(out['correct'], 'radish_pt_tpu_torch' in tops, forbidden_modules())")
    assert _run(code) == "True True []"


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(n.split(".")[0] in ("torch", "numpy", "scipy", "PIL", "imageio",
                                           "__future__", "dataclasses", "functools",
                                           "os", "contextlib", "warnings")
                       for n in names), (path, names)
    code = (f"import sys; sys.path[:0] = [{BENCH!r}]\n"
            "from reference import shading, pathtrace, restir, gbuffer, post\n"
            "import torch\n"
            "ds, cam, _ = shading.load_scene('scenes/cornell_box.txt', 'cpu')\n"
            "cam = cam.replace(width=16, height=16)\n"
            "d, i = pathtrace.path_trace(ds, cam, 3, 2, torch.arange(256, dtype=torch.int32))\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'radish_pt_tpu_torch', 'radish_pt_tpu', 'jax', 'harness'}))")
    assert _run(code) == "[]"
