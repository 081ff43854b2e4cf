"""The control-plane entry points, the JAX package's ``cmd.py``: the
vc-scheduler and vc-controller-manager binaries (Volcano's
cmd/scheduler/app/server.go:57-141, cmd/controller-manager/app/
server.go:51-130).

The in-process deployment runs everything in one VolcanoSystem; these
binaries serve the split topology, a store on one side and the scheduler
and controllers as separate processes with leader election on the other.
The scheduler solves on the CUDA card unless ``--device cpu`` asks for the
CPU.

Refused by name, each with exit code 2 and the ROADMAP item it waits for:
``--native-store`` (the C++ object store), ``--listen-address`` (the
metrics and health HTTP server) and the vc-snapshot-rpc sidecar
(``snapshot_rpc_main``, the snapshot RPC).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import List, Optional

# option -> what it waits for
REFUSED = {
    "--native-store": "the C++ object store (ROADMAP item 9f′)",
    "--listen-address": "the metrics and health HTTP server (ROADMAP item "
                        "9f′)",
    "vc-snapshot-rpc": "the snapshot RPC sidecar (ROADMAP item 9f′)",
}


def _refuse(prog: str, what: str) -> int:
    print(f"{prog}: {what} is not in volcano_tpu_torch yet: it needs "
          f"{REFUSED[what]}", file=sys.stderr)
    return 2


def _add_refused(parser: argparse.ArgumentParser) -> None:
    """The refused options parse (so a deployment's flags are named in the
    refusal, never ignored) and refuse after parsing."""
    parser.add_argument("--native-store", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--listen-address", type=int, default=0,
                        metavar="PORT", help=argparse.SUPPRESS)


def _refused_in(prog: str, args) -> Optional[int]:
    if args.native_store:
        return _refuse(prog, "--native-store")
    if args.listen_address:
        return _refuse(prog, "--listen-address")
    return None


def scheduler_main(argv: Optional[List[str]] = None) -> int:
    """vc-scheduler: the full in-process control plane with the scheduling
    loop in the foreground (flags mirror the Volcano scheduler's)."""
    parser = argparse.ArgumentParser(prog="vc-scheduler")
    parser.add_argument("--scheduler-conf", default=None,
                        help="YAML conf path (hot-reloaded on change)")
    parser.add_argument("--schedule-period", type=float, default=1.0)
    parser.add_argument("--default-queue", default="default")
    parser.add_argument("--leader-elect", action="store_true",
                        help="acquire the store lease before scheduling")
    parser.add_argument("--journal", default=None, metavar="PATH",
                        help="write-ahead intent journal file: bind and "
                             "evict intents are journaled before execution "
                             "and reconciled at startup, so a scheduler "
                             "killed mid-cycle restarts without double "
                             "binds (VOLCANO_TPU_JOURNAL=0 disables)")
    parser.add_argument("--device", default=None,
                        help="where sessions solve: the CUDA card by "
                             "default, or cpu")
    _add_refused(parser)
    args = parser.parse_args(argv)
    refused = _refused_in(parser.prog, args)
    if refused is not None:
        return refused

    from .system import VolcanoSystem
    sys_ = VolcanoSystem(schedule_period=args.schedule_period,
                         default_queue=args.default_queue,
                         device=args.device)
    sys_.scheduler.conf_path = args.scheduler_conf
    if args.journal:
        from .cache.journal import IntentJournal
        sys_.cache.attach_journal(IntentJournal(args.journal))
    signal.signal(signal.SIGTERM, lambda *_: sys_.stop())
    try:
        if args.leader_elect:
            sys_.scheduler.run_with_leader_election(sys_.store)
        else:
            sys_.scheduler.run()
    except KeyboardInterrupt:
        sys_.stop()
    return 0


def controller_manager_main(argv: Optional[List[str]] = None) -> int:
    """vc-controller-manager: store, webhooks and controllers, no
    scheduler."""
    parser = argparse.ArgumentParser(prog="vc-controller-manager")
    parser.add_argument("--leader-elect", action="store_true")
    _add_refused(parser)
    args = parser.parse_args(argv)
    refused = _refused_in(parser.prog, args)
    if refused is not None:
        return refused

    from .controllers import start_controllers
    from .store import ObjectStore
    from .webhooks import register_webhooks
    store = ObjectStore()
    register_webhooks(store)
    start_controllers(store)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())

    def wait() -> int:
        try:
            stop.wait()
        except KeyboardInterrupt:
            pass
        return 0

    if args.leader_elect:
        from .leaderelection import LeaderElector
        LeaderElector(store, "vc-controller-manager",
                      on_started_leading=wait).run()
        return 0
    return wait()


def snapshot_rpc_main(argv: Optional[List[str]] = None) -> int:
    """vc-snapshot-rpc, the scheduler sidecar a Go shim talks to: refused
    by name."""
    return _refuse("vc-snapshot-rpc", "vc-snapshot-rpc")
