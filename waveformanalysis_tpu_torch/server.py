"""Resident pipeline server: keep one warm process serving many requests.

A fresh process pays fixed costs before its first result: the torch
import, the CUDA context, loading the kernel libraries (built once per
source hash under ``build/kernels``) and the first launches. The reference
has no serving story (each CLI invocation is a fresh process,
reference: waveform_analysis/cli.py:23-230). A RESIDENT process keeps one
Context, and with it the loaded kernels, the memory cache and the async
writer thread, warm across requests. The Context moves the device columns
of the tables a request cached to the host when the request returns, so
the memory it holds on the card does not grow with the requests.

Protocol: newline-delimited JSON over a unix domain socket. Requests:

    {"op": "ping"}
    {"op": "get_data", "run_id": "...", "names": ["df_events", ...]}
    {"op": "get_data_batched", "run_ids": [...], "names": [...]}
    {"op": "stats"}
    {"op": "flush"}
    {"op": "shutdown"}

Results are computed THROUGH the normal Context path, so they persist into
the lineage-keyed cache; the response carries row counts and cache keys,
and any other Context over the same storage dir (including short-lived CLI
processes) reads the materialized data directly. ``serve_forever`` handles
one client at a time on the thread that calls it — the Context is not
thread-safe by contract — while the async writer saves on its own thread;
``flush`` and ``shutdown`` wait for the writer before they reply.

Port of ``waveformanalysis_tpu/server.py``, run as
``python -m waveformanalysis_tpu_torch.server``: ``--device`` (default
``cuda``; raises without a card) and the port's profile names (default
``cuda``).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def _describe(result: Any) -> Dict[str, Any]:
    try:
        n = len(result)
    except TypeError:
        n = None
    return {"rows": n, "type": type(result).__name__}


class PipelineServer:
    """Serves get_data requests from one resident Context."""

    def __init__(self, context: Any, socket_path: str) -> None:
        self.ctx = context
        self.socket_path = str(socket_path)
        self._requests = 0
        self._started = time.time()
        self._shutdown = threading.Event()
        self._server: Optional[socketserver.UnixStreamServer] = None

    # -- request handling ----------------------------------------------------

    def handle_request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        self._requests += 1
        op = req.get("op")
        t0 = time.perf_counter()
        try:
            if op == "ping":
                return {"ok": True, "pong": True}
            if op == "get_data":
                run_id = req["run_id"]
                names = req.get("names") or [req["name"]]
                out = self.ctx.get_data(run_id, list(names))
                return {
                    "ok": True,
                    "results": {
                        name: dict(
                            _describe(data),
                            key=self.ctx.key_for(run_id, name),
                        )
                        for name, data in out.items()
                    },
                    "seconds": time.perf_counter() - t0,
                }
            if op == "get_data_batched":
                run_ids = list(req["run_ids"])
                names = list(req.get("names") or [req["name"]])
                out = self.ctx.get_data_batched(run_ids, names)
                return {
                    "ok": True,
                    "results": {
                        rid: {
                            name: dict(
                                _describe(out[rid][name]),
                                key=self.ctx.key_for(rid, name),
                            )
                            for name in names
                        }
                        for rid in run_ids
                    },
                    "seconds": time.perf_counter() - t0,
                }
            if op == "stats":
                return {
                    "ok": True,
                    "requests": self._requests,
                    "uptime_s": time.time() - self._started,
                    "registered": sorted(self.ctx.plugins),
                    "storage_dir": str(getattr(self.ctx, "storage_dir", "")),
                }
            if op == "flush":
                self.ctx.flush_saves()
                return {"ok": True}
            if op == "shutdown":
                self.ctx.flush_saves()
                self._shutdown.set()
                return {"ok": True, "bye": True}
            return {"ok": False, "error": f"unknown op {op!r}"}
        except Exception as e:  # noqa: BLE001 - errors go to the client
            logger.exception("request failed: %s", req)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    # -- socket loop ---------------------------------------------------------

    def serve_forever(self) -> None:
        """Blocking accept loop; returns after a shutdown request."""
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for raw in self.rfile:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as e:
                        resp = {"ok": False, "error": f"bad json: {e}"}
                    else:
                        resp = outer.handle_request(req)
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode()
                    )
                    self.wfile.flush()
                    if outer._shutdown.is_set():
                        return

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        with socketserver.UnixStreamServer(self.socket_path, Handler) as srv:
            self._server = srv
            srv.timeout = 0.5
            while not self._shutdown.is_set():
                srv.handle_request()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self.ctx.flush_saves()


def request(socket_path: str, payload: Dict[str, Any],
            timeout: float = 600.0) -> Dict[str, Any]:
    """One round trip to a running PipelineServer."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(str(socket_path))
        s.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    if not buf.strip():
        # connection closed without a reply (shutdown race, crashed
        # handler) — OSError so wait_ready keeps polling
        raise ConnectionError("server closed connection without a response")
    return json.loads(buf)


def wait_ready(socket_path: str, timeout: float = 60.0) -> bool:
    """Poll until the server answers ping (daemon startup barrier)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if request(socket_path, {"op": "ping"}, timeout=5.0).get("pong"):
                return True
        except OSError:
            time.sleep(0.05)
    return False


def main(argv: Optional[List[str]] = None) -> int:
    """``waveform-serve``: stand up a resident pipeline server."""
    import argparse

    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import PROFILES, get_profile

    p = argparse.ArgumentParser(
        prog="waveform-serve",
        description="Resident waveform pipeline server (unix socket, "
                    "newline-delimited JSON)",
    )
    p.add_argument("--socket", required=True, help="Unix socket path")
    p.add_argument("--storage-dir", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--daq-adapter", default="vx2730")
    p.add_argument("--profile", default="cuda", choices=sorted(PROFILES))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the device programs (default cuda; "
                        "raises when no card is present, never falls back)")
    p.add_argument("--config-json", default=None,
                   help="Extra context config as a JSON object or file path")
    args = p.parse_args(argv)

    config: Dict[str, Any] = {"show_progress": False}
    if args.data_root:
        config["data_root"] = args.data_root
        config["daq_adapter"] = args.daq_adapter
    if args.config_json:
        blob = args.config_json
        if os.path.exists(blob):
            with open(blob) as fh:
                blob = fh.read()
        config.update(json.loads(blob))
    config["device"] = args.device  # the flag alone picks the device
    ctx = Context(storage_dir=args.storage_dir, config=config)
    ctx.register(*get_profile(args.profile))
    server = PipelineServer(ctx, args.socket)
    print(f"waveform-serve: listening on {args.socket}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
