"""The control-plane entry points, the JAX package's ``cmd.py``: the
vc-scheduler and vc-controller-manager binaries (Volcano's
cmd/scheduler/app/server.go:57-141, cmd/controller-manager/app/
server.go:51-130) and the vc-snapshot-rpc sidecar a Go shim talks to.

The in-process deployment runs everything in one VolcanoSystem; these
binaries serve the split topology: a store (or a Go shim against a real
API server) on one side, the scheduler and the controllers as separate
processes with leader election on the other. The scheduler and the
sidecar solve on the CUDA card unless ``--device cpu`` asks for the CPU.
``--native-store`` backs the store with the C++ one (``native/``);
``--listen-address PORT`` serves /metrics, /healthz and /debug on PORT
(``metrics.start_metrics_server``).

    python -m volcano_tpu_torch.cmd vc-snapshot-rpc --port 7070 \
        --scheduler-conf deploy/scheduler.conf --listen-address 8080
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time
from typing import List, Optional


def _add_common(parser: argparse.ArgumentParser,
                native_store: bool = True) -> None:
    if native_store:
        parser.add_argument("--native-store", action="store_true",
                            help="back the store with the C++ object store "
                                 "(built with g++ at first use)")
    parser.add_argument("--listen-address", type=int, default=0,
                        metavar="PORT",
                        help="serve /metrics, /healthz and /debug on this "
                             "port (0: off)")


def _listen(args) -> None:
    if args.listen_address:
        from . import metrics
        metrics.start_metrics_server(args.listen_address)


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
    _add_common(parser)
    args = parser.parse_args(argv)

    from .system import VolcanoSystem
    sys_ = VolcanoSystem(schedule_period=args.schedule_period,
                         default_queue=args.default_queue,
                         native_store=args.native_store,
                         device=args.device)
    _listen(args)
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
    _add_common(parser)
    args = parser.parse_args(argv)

    from .controllers import start_controllers
    from .native import make_object_store
    from .webhooks import register_webhooks
    store = make_object_store(prefer_native=args.native_store)
    register_webhooks(store)
    start_controllers(store)
    _listen(args)
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


def load_kernels() -> None:
    """Build (nvcc, one process a source, at once) and load every hand
    kernel, so the first request does not pay the build."""
    from .ops import build
    build.build_all()
    for name in build.KERNELS:
        build.load(name)


def _watch_conf(path: str, service, period_s: float = 2.0) -> None:
    """The conf hot reload: an mtime watch on the mounted file, applied
    between cycles (pkg/filewatcher, scheduler.go:112-170). A conf that
    fails to load keeps the running one."""
    last = os.stat(path).st_mtime
    while True:
        time.sleep(period_s)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            continue
        if mtime == last:
            continue
        last = mtime
        try:
            with open(path) as f:
                service.reload_conf(f.read())
        except (OSError, ValueError) as exc:
            print(f"vc-snapshot-rpc: scheduler conf not reloaded: {exc}",
                  file=sys.stderr, flush=True)
            continue
        print("vc-snapshot-rpc: scheduler conf reloaded", flush=True)


def snapshot_rpc_main(argv: Optional[List[str]] = None) -> int:
    """vc-snapshot-rpc: the scheduler sidecar a Go shim talks to, over the
    length-prefixed TCP protocol of ``rpc/server.py``."""
    parser = argparse.ArgumentParser(prog="vc-snapshot-rpc")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument("--scheduler-conf", default=None,
                        help="YAML conf path (hot-reloaded on change)")
    parser.add_argument("--device", default=None,
                        help="where sessions solve: the CUDA card by "
                             "default, or cpu")
    _add_common(parser, native_store=False)
    args = parser.parse_args(argv)

    conf_text = None
    if args.scheduler_conf:
        with open(args.scheduler_conf) as f:
            conf_text = f.read()
    from .framework import resolve_device
    from .rpc import serve
    device = resolve_device(args.device)
    if device.type == "cuda":
        load_kernels()
    _listen(args)
    server, thread, port = serve(args.host, args.port, conf_text,
                                 device=device)
    print(f"vc-snapshot-rpc listening on {args.host}:{port}", flush=True)
    if args.scheduler_conf:
        threading.Thread(target=_watch_conf,
                         args=(args.scheduler_conf, server.service),
                         daemon=True, name="conf-watch").start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    server.shutdown()
    server.server_close()
    return 0


BINARIES = {"vc-scheduler": scheduler_main,
            "vc-controller-manager": controller_manager_main,
            "vc-snapshot-rpc": snapshot_rpc_main}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m volcano_tpu_torch.cmd BINARY [flags]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in BINARIES:
        print(f"usage: python -m volcano_tpu_torch.cmd "
              f"{{{','.join(BINARIES)}}} [flags]", file=sys.stderr)
        return 2
    return BINARIES[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
