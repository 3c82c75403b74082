"""The port's examples run end to end on the CPU (``--device cpu``, the
kernels' plain twins), each in a child process as a user would run it:
``examples/torch_quickstart.py`` (its seven snippets check themselves) and
``examples/torch_serve_lm.py`` for one architecture of each family served
from tokens, ``examples/torch_moe_routing.py`` (its dispatch checks and 20
training steps whose loss must drop) and ``examples/torch_train_lm.py``
(20 steps with a checkpoint half way), at small arguments.  The plan cache goes to a temporary path.
"""
import os
import subprocess
import sys

import pytest
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, *args):
    # one intra-op thread a child: the test workers share the machine's cores
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1",
           "REPRO_TORCH_OPS_PLAN_CACHE": str(tmp_path / "plans.json")}
    r = subprocess.run([sys.executable, *args, "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_quickstart_runs_on_the_cpu(tmp_path):
    out = _run(tmp_path, "examples/torch_quickstart.py")
    assert "quickstart OK" in out and "5. distributed sort" in out


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b", "rwkv6-1.6b", "zamba2-2.7b"])
def test_serve_lm_runs_on_the_cpu(tmp_path, arch):
    out = _run(tmp_path, "examples/torch_serve_lm.py", "--arch", arch, "--new", "10")
    assert "scheduler picked 4 of 8" in out and "deterministic" in out


def test_moe_routing_runs_on_the_cpu(tmp_path):
    out = _run(tmp_path, "examples/torch_moe_routing.py")
    assert "ops.group_by == dispatch-rank grouping" in out and "layers routed in one" in out
    assert "(gradients flow) — OK" in out


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-moe-16b"])
def test_train_lm_runs_on_the_cpu(tmp_path, arch):
    out = _run(tmp_path, "examples/torch_train_lm.py", "--arch", arch, "--steps", "20")
    assert "step 20:" in out and "final: {" in out
