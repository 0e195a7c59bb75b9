"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference, the weights and the traffic load
nothing of the port."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "vacnic_tpu")


def loaded_after(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in out.stdout.split()}


def test_run_loads_no_jax():
    code = ("import os\n"
            "from portbench import run, harness, control\n"
            "for d in os.listdir('portbench/drivers'):\n"
            "    if d.endswith('.py'): harness.driver_module(d[:-3])\n"
            "for m in os.listdir('portbench/metrics'):\n"
            "    if m.endswith('.py'): harness.metric_reader(m[:-3])\n"
            "import vacnic_tpu_torch.infer.generate, vacnic_tpu_torch.serve\n"
            "import vacnic_tpu_torch.train.train_step, vacnic_tpu_torch.kernels._build\n"
            "from portbench.reference import model, train\n")
    mods = loaded_after(code)
    assert "vacnic_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_reference_weights_traffic_load_nothing_of_the_port():
    mods = loaded_after("from portbench.reference import model, train\n"
                        "from portbench import weights, costs\n"
                        "from portbench.traffic import synthetic\n")
    assert "vacnic_tpu_torch" not in mods and not mods & set(FORBIDDEN)


def test_reference_sources_import_only_torch_numpy_and_itself():
    for sub in ("reference", "traffic", "costs"):
        for f in os.listdir(os.path.join(HERE, sub)):
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(HERE, sub, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                for n in names:
                    top = n.split(".")[0]
                    assert top in ("torch", "numpy", "__future__", "portbench"), (f, n)
                    if top == "portbench":
                        assert n.startswith(("portbench.reference", "portbench.traffic")), (f, n)
