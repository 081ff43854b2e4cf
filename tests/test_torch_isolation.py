"""volcano_tpu_torch stands alone: it imports neither JAX nor any module of
the JAX package — not while it runs the slice conf, nor deploy/scheduler.conf
with its preempt walk, drf, predicates and proportion, nor the in-process
system (webhooks, controllers, vcctl, ``VolcanoSystem``, ``cmd``) and the
elastic membership controller, nor the snapshot RPC, the native store and
the metrics endpoint, nor tools/system_reference.py and
tools/rpc_reference.py driving the port's worlds — and its entry points
refuse to fall back to the CPU when no CUDA device is there."""

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
        "import volcano_tpu_torch.actions.evict_tpu\n"
        "import volcano_tpu_torch.ops.evict\n"
        "import volcano_tpu_torch.ops.fairness\n"
        "import volcano_tpu_torch.plugins.drf\n"
        "import volcano_tpu_torch.plugins.predicates\n"
        "import volcano_tpu_torch.plugins.proportion\n"
        "from volcano_tpu_torch.cache.synthetic import baseline_config\n"
        f"conf = {SLICE_CONF!r}\n"
        "cache, binder, _ = baseline_config('1k')\n"
        "Scheduler(cache, conf, device='cpu').run_once()\n"
        "assert len(binder.binds) == 1000, len(binder.binds)\n"
        f"deployed = open({str(REPO / 'deploy' / 'scheduler.conf')!r}).read()\n"
        "cache, binder, evictor = baseline_config('preempt-small')\n"
        "Scheduler(cache, deployed, device='cpu').run_once()\n"
        "assert binder.binds, 'the deployed cycle bound nothing'\n"
        "import volcano_tpu_torch.cmd\n"
        "import volcano_tpu_torch.cli.verbs\n"
        "import volcano_tpu_torch.federation.elastic\n"
        "from volcano_tpu_torch.system import VolcanoSystem\n"
        "from volcano_tpu_torch.api import NodeInfo, Resource\n"
        "system = VolcanoSystem(conf_text=deployed, device='cpu')\n"
        "alloc = Resource(8000, 32 << 30)\n"
        "alloc.max_task_num = 110\n"
        "system.cache.add_node(NodeInfo(name='n0', allocatable=alloc))\n"
        "system.jobs.run('j', replicas=2)\n"
        "assert system.schedule_once() == [] == system.schedule_once()\n"
        "assert [p.status.phase for p in system.store.list('Pod')] == "
        "['Running', 'Running']\n"
        f"sys.path.insert(0, {str(REPO / 'tools')!r})\n"
        "import system_reference\n"
        "out = system_reference.run_world('volcano_tpu_torch', "
        "'system-lifecycle', 'cpu')\n"
        "assert out['action_failures'] == []\n"
        "import rpc_reference\n"
        "from volcano_tpu_torch import metrics\n"
        "from volcano_tpu_torch.native import NativeObjectStore\n"
        "from volcano_tpu_torch.rpc import SnapshotClient, serve\n"
        "import json\n"
        f"golden = json.load(open({str(REPO / 'shim' / 'testdata' / 'golden_snapshot.json')!r}))\n"
        "server, _, port = serve(conf_text=deployed, device='cpu')\n"
        "client = SnapshotClient('127.0.0.1', port)\n"
        "assert client.schedule(golden)['binds']\n"
        "client.close(); server.shutdown()\n"
        "assert b'volcano_plugin_scheduling_latency' in "
        "metrics.fallback_exposition()\n"
        "out = system_reference.run_world('volcano_tpu_torch', "
        "'system-preempt', 'cpu', native=True)\n"
        "assert isinstance(out['system'].store, NativeObjectStore)\n"
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
