"""The port's four examples (``repro_torch.examples``) against the JAX
package's ``examples/``.

``quickstart`` and ``drift_demo`` run only the host layers the port
copies byte for byte: their output must be the JAX example's, byte for
byte. ``multi_tenant_serving --preset smoke --device cpu`` runs the
port's slot-ring engine on the JAX example's smoke model; the engine
retires at the oracle end of sequence, so every printed line but the
wall-clock figure is independent of the weights and must equal the JAX
example's. ``train_lm`` at smoke size trains 3 steps on the CPU and
writes a checkpoint.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.examples import multi_tenant_serving, train_lm

ROOT = Path(__file__).resolve().parents[1]
WALL = re.compile(r"\(\d+\.\ds wall on CPU\)")


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, *args], env=env, cwd=ROOT,
                         text=True, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("name", ["quickstart", "drift_demo"])
def test_host_examples_print_what_jax_prints(name):
    want = _run([f"examples/{name}.py"])
    got = _run(["-m", f"repro_torch.examples.{name}"])
    assert got == want


def test_multi_tenant_serving_smoke_prints_the_jax_lines(capsys):
    want = _run(["examples/multi_tenant_serving.py", "--requests", "8"])
    engine, wall = multi_tenant_serving.main(
        ["--preset", "smoke", "--device", "cpu", "--requests", "8"])
    got = capsys.readouterr().out
    assert engine.step_count > 0 and wall >= 0
    assert len(WALL.findall(got)) == 1
    assert WALL.sub("", got) == WALL.sub("", want)


def test_train_lm_smoke_trains_and_checkpoints(tmp_path, capsys):
    assert train_lm.main(["--steps", "3", "--device", "cpu",
                          "--checkpoint-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=smollm-135m-smoke ")
    assert [line.split()[1] for line in out[1:]] == ["0", "2"]
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
