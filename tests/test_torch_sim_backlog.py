"""``trace:backlog-16k`` (tools/sim_traces.py: 2,000 gangs, about 16,000
pods, on 300 nodes of 32 CPU / 128 GiB / 110 pods, a standing backlog
drained over about 100 cycles) through the port's pipelined sim on the
CPU, held to the JAX package's committed digest in
tests/sim_reference_digests.json: decision plane (with the speculation
verdicts), side-effect sequence and node-tensor paths. A file of its own:
the run takes about 100 s here.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

from volcano_tpu_torch.actions import allocate as torch_allocate
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.sim.__main__ import main as sim_main
from volcano_tpu_torch.sim.report import sequence_digest

from torch_parity import port_gc_windows  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sim_traces import TensorPathRecorder  # noqa: E402


def _tool():
    spec = importlib.util.spec_from_file_location(
        "sim_reference", REPO / "tools" / "sim_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
RUN = ("trace:backlog-16k", ("--pipelined",), ())


def test_backlog_16k_matches_jax_digest(tmp_path):
    doc = json.loads((REPO / "tests" / "sim_reference_digests.json")
                     .read_text())
    want = {run["key"]: run for run in doc["runs"]}[TOOL.run_key(*RUN)]
    out = io.StringIO()
    runners = []
    paths = TensorPathRecorder(torch_allocate, SchedulerCache)
    try:
        with contextlib.redirect_stdout(out):
            rc = sim_main(["--device", "cpu",
                           *TOOL.sim_argv(RUN[0], str(tmp_path)),
                           "--deterministic", *RUN[1]], runners=runners)
    finally:
        paths.close()
    assert rc == 0
    text = out.getvalue().encode()
    sequence = sequence_digest(runners[0])
    summary = paths.summary()
    assert hashlib.sha256(text).hexdigest() == want["sha256"]
    assert len(text) == want["bytes"]
    assert (sequence["sha256"], sequence["binds"], sequence["evicts"]) \
        == (want["sequence_sha256"], want["sequence_binds"],
            want["sequence_evicts"])
    assert summary == want["tensor_paths"]
    report = json.loads(text)
    assert report["action_failures"] == 0 and report["double_binds"] == 0
    assert report["jobs"]["completed"] == report["jobs"]["arrived"] == 2000
    spec = report["speculation"]
    # a speculation is dispatched in more than half of the cycles, and the
    # run meets all three commit verdicts
    assert spec["hits"] + spec["partial"] + spec["conflicts"] \
        > report["cycles"] / 2
    assert spec["hits"] and spec["partial"] and spec["conflicts"]
