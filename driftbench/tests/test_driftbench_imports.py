"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names are compared whole (``repro_torch`` starts with
``repro``)."""

import subprocess
import sys

from driftbench.bench import ROOT


def _run_py():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "driftbench_run_cli", ROOT / "driftbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forbidden_names_are_whole_top_level_names():
    run = _run_py()
    assert run.loaded_forbidden(["repro_torch", "repro_torch.serving",
                                 "reprography", "jaxtyping"]) == []
    assert run.loaded_forbidden(["repro.core", "jax.numpy", "jaxlib",
                                 "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "import driftbench.harness, driftbench.check, driftbench.trace\n"
        "import driftbench.control, driftbench.sweep\n"
        "import repro_torch.serving.engine, repro_torch.core.scheduler\n"
        "import repro_torch.configs, repro_torch.models.registry\n"
        "from driftbench import bench\n"
        "man = bench.manifest()\n"
        "for m in man['end_to_end'] + man['per_layer']:\n"
        "    bench.reader(m['name'])\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'repro'})\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "driftbench/run.py", "--workload",
         "h2o-danube-1.8b.chat.paced", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=240, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                          "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
