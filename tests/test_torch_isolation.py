"""volcano_tpu_torch stands alone: it imports neither JAX nor any module of
the JAX package, and its entry points refuse to fall back to the CPU when
no CUDA device is there."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from volcano_tpu_torch import Scheduler
from volcano_tpu_torch.cache import synthetic
from volcano_tpu_torch.framework import open_session, parse_scheduler_conf

from torch_parity import SLICE_CONF

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "volcano_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_cycle_runs_without_jax():
    """A subprocess, because this test process imported JAX already (the
    test configuration does)."""
    code = (
        "import sys\n"
        "from volcano_tpu_torch import Scheduler\n"
        "from volcano_tpu_torch.cache.synthetic import baseline_config\n"
        f"conf = {SLICE_CONF!r}\n"
        "cache, binder, _ = baseline_config('1k')\n"
        "Scheduler(cache, conf, device='cpu').run_once()\n"
        "assert len(binder.binds) == 1000, len(binder.binds)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'volcano_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "volcano_tpu"), \
                f"{path}:{node.lineno} imports {name}"


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cache = synthetic.baseline_config("tiny")[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(cache, SLICE_CONF)
    conf = parse_scheduler_conf(SLICE_CONF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_session(cache, conf.tiers, conf.configurations)
