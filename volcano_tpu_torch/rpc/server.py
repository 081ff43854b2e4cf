"""The snapshot RPC's length-prefixed TCP transport (the JAX package's
``rpc/server.py``).

Both directions: a 4-byte big-endian payload length, then UTF-8 JSON. An
error reply is ``{"error": "..."}`` in the same framing, and the
connection keeps serving. A message longer than ``MAX_MSG`` ends the
connection: its frame cannot be skipped without reading it.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple

from .service import SchedulerService

MAX_MSG = 1 << 30


class BadPayload(Exception):
    """The frame arrived whole but its JSON is invalid: the server replies
    with an error and keeps the connection."""


def _read_exact(sock, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _read_msg(sock) -> Optional[dict]:
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_MSG:
        raise ValueError(f"message too large: {length}")
    body = _read_exact(sock, length)
    if body is None:
        return None
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise BadPayload(str(exc)) from exc


def _write_msg(sock, msg: dict) -> None:
    body = json.dumps(msg).encode("utf-8")
    sock.sendall(struct.pack(">I", len(body)) + body)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        while True:
            try:
                msg = _read_msg(self.request)
            except BadPayload as exc:
                _write_msg(self.request, {"error": f"bad payload: {exc}"})
                continue
            except (ConnectionError, ValueError):
                return
            if msg is None:
                return
            try:
                if msg.get("op") == "admit":
                    out = self.server.admission.admit(msg)
                else:
                    out = self.server.service.schedule(msg)
            except Exception as exc:  # the wire carries it; keep serving
                out = {"error": f"{type(exc).__name__}: {exc}"}
            _write_msg(self.request, out)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve(host: str = "127.0.0.1", port: int = 0,
          conf_text: Optional[str] = None, device=None,
          ) -> Tuple[_Server, threading.Thread, int]:
    """Start the sidecar on a daemon thread; returns (server, thread,
    bound port). ``device`` is the service's (the card by default)."""
    from .admission import AdmissionOverWire
    service = SchedulerService(conf_text, device=device)
    server = _Server((host, port), _Handler)
    server.service = service
    server.admission = AdmissionOverWire()
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="vc-snapshot-rpc")
    thread.start()
    return server, thread, server.server_address[1]


class SnapshotClient:
    """The Go shim's side, for tests and Python callers: connect, send a
    snapshot, read the decisions."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def schedule(self, snapshot_msg: dict) -> dict:
        _write_msg(self.sock, snapshot_msg)
        out = _read_msg(self.sock)
        if out is None:
            raise ConnectionError("server closed the connection")
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def admit(self, kind: str, operation: str, obj: dict,
              old: Optional[dict] = None,
              context: Optional[dict] = None) -> dict:
        """One admission review through the wire; returns {"allowed",
        "message", "patched"}."""
        from .codec import VERSION
        return self.schedule({
            "v": VERSION, "op": "admit",
            "review": {"kind": kind, "operation": operation, "object": obj,
                       "old": old, "context": context or {}}})

    def close(self) -> None:
        self.sock.close()
