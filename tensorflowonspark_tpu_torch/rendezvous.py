"""Cluster rendezvous: a TCP registry that assembles the job's topology.

An own copy of the part of ``tensorflowonspark_tpu/rendezvous.py`` that
the SPARK-fed training path calls: a ``Server`` on the driver, a
``Client`` in each node, length-prefixed JSON messages (REG, QUERY,
QINFO, STOP, and the feed ledger's PDONE/PQUERY).  What the
registry produces is what ``torch.distributed.init_process_group``
needs: every node's host and reserved port, from which the node runtime
derives the coordinator address, the world size and each rank.

Left out: the epoch fence and resize of cluster recovery (ROADMAP.md
queue 1, item 15).  Env overrides as in the JAX package:
``TFOS_SERVER_HOST`` (bind/advertise host) and ``TFOS_SERVER_PORT``
(port, comma list and/or ``lo-hi`` ranges).
"""

from __future__ import annotations

import json
import logging
import os
import random
import select
import socket
import struct
import threading
import time

from tensorflowonspark_tpu_torch.actors.ledger import DeliveryLedger
from tensorflowonspark_tpu_torch.utils import faults, get_ip_address

logger = logging.getLogger(__name__)

TFOS_SERVER_HOST = "TFOS_SERVER_HOST"
TFOS_SERVER_PORT = "TFOS_SERVER_PORT"

MAX_RETRIES = 3          # client connect retries
POLL_SECS = 0.25         # client await poll interval
DEFAULT_TIMEOUT = 600    # driver-side await timeout

_HEADER = struct.Struct(">I")


def _candidate_ports():
    """Candidate ports from TFOS_SERVER_PORT ('p', 'p1,p2', 'lo-hi')."""
    spec = os.environ.get(TFOS_SERVER_PORT)
    if not spec:
        yield 0
        return
    for part in str(spec).split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            yield from range(int(lo), int(hi) + 1)
        elif part:
            yield int(part)


class Reservations:
    """Thread-safe store of node registrations."""

    def __init__(self, required):
        self.required = int(required)
        self._lock = threading.Lock()
        self._reservations = []

    def add(self, meta):
        with self._lock:
            self._reservations.append(meta)

    def done(self):
        with self._lock:
            return len(self._reservations) >= self.required

    def get(self):
        with self._lock:
            return list(self._reservations)

    def remaining(self):
        with self._lock:
            return self.required - len(self._reservations)


class MessageSocket:
    """Length-prefixed JSON messages over a stream socket."""

    # a corrupt or hostile length prefix must not make either end buffer
    # gigabytes; 64 MB is far above the largest real frame
    MAX_FRAME = 64 << 20

    def receive(self, sock):
        header = self._recv_exact(sock, _HEADER.size)
        if header is None:
            return None
        (length,) = _HEADER.unpack(header)
        if length > self.MAX_FRAME:
            logger.warning("dropping connection: frame length %d exceeds %d",
                           length, self.MAX_FRAME)
            return None
        payload = self._recv_exact(sock, length)
        if payload is None:
            return None
        return json.loads(payload.decode("utf-8"))

    def send(self, sock, msg):
        payload = json.dumps(msg).encode("utf-8")
        sock.sendall(_HEADER.pack(len(payload)) + payload)

    @staticmethod
    def _recv_exact(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf


class Server(MessageSocket):
    """The rendezvous server, run on the driver."""

    def __init__(self, count):
        self.reservations = Reservations(count)
        # ``done`` is the application-level STOP signal (a consumer's
        # DataFeed.terminate() sends STOP); the server keeps serving
        # until stop()
        self.done = threading.Event()
        self._closing = threading.Event()
        self._listener = None
        self._thread = None
        # feed ledger: feeders report each fully consumed partition
        self._feeds = DeliveryLedger()

    def fed_partitions(self, feed="input"):
        """Sorted partition indices recorded as fully consumed."""
        return self._feeds.done_units(feed)

    def reset_feed(self, feed="input"):
        """Clear ``feed``'s ledger (each ``train()`` owns one scope)."""
        self._feeds.reset(feed)

    def start(self):
        """Bind, start the select() loop thread, return (host, port)."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        host = os.environ.get(TFOS_SERVER_HOST) or ""
        last_err = None
        for port in _candidate_ports():
            try:
                listener.bind((host, port))
                break
            except OSError as e:  # try the next candidate
                last_err = e
        else:
            listener.close()
            raise OSError(f"no usable port from {TFOS_SERVER_PORT}: "
                          f"{last_err}")
        listener.listen(64)
        bound_port = listener.getsockname()[1]
        advertise = os.environ.get(TFOS_SERVER_HOST) or get_ip_address()
        self._listener = listener
        self._thread = threading.Thread(target=self._serve,
                                        name="rendezvous-server", daemon=True)
        self._thread.start()
        addr = (advertise, bound_port)
        logger.info("rendezvous server listening on %s", addr)
        return addr

    def _serve(self):
        conns = [self._listener]
        while not self._closing.is_set():
            try:
                readable, _, _ = select.select(conns, [], [], 0.25)
            except OSError:
                break
            for sock in readable:
                if sock is self._listener:
                    try:
                        conn, _ = self._listener.accept()
                        # a stalled client must not freeze the loop
                        conn.settimeout(10.0)
                        conns.append(conn)
                    except OSError:
                        pass
                    continue
                try:
                    msg = self.receive(sock)
                except (OSError, ValueError):
                    msg = None
                if msg is None:
                    conns.remove(sock)
                    sock.close()
                    continue
                self._handle_message(sock, msg)
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass

    def _handle_message(self, sock, msg):
        kind = msg.get("type")
        if kind == "REG":
            self.reservations.add(msg["data"])
            self.send(sock, {"type": "OK"})
        elif kind == "PDONE":
            self._feeds.record(msg.get("feed", "input"), int(msg["part"]))
            self.send(sock, {"type": "OK"})
        elif kind == "PQUERY":
            self.send(sock, {"type": "PQUERY", "data": self.fed_partitions(
                msg.get("feed", "input"))})
        elif kind == "QUERY":
            self.send(sock, {"type": "QUERY",
                             "data": self.reservations.done()})
        elif kind == "QINFO":
            self.send(sock, {"type": "QINFO",
                             "data": self.reservations.get()})
        elif kind == "STOP":
            self.done.set()  # before the reply: an acknowledged STOP holds
            self.send(sock, {"type": "OK"})
        else:
            self.send(sock, {"type": "ERR",
                             "data": f"unknown message {kind!r}"})

    def await_reservations(self, status=None, timeout=DEFAULT_TIMEOUT):
        """Block until every node registered.  ``status`` is the driver's
        shared dict; an 'error' set by the launcher thread aborts."""
        deadline = time.time() + timeout
        while not self.reservations.done():
            if status and status.get("error"):
                raise RuntimeError(f"node startup failed: {status['error']}")
            if time.time() > deadline:
                raise TimeoutError(
                    f"timed out waiting for {self.reservations.remaining()} "
                    f"of {self.reservations.required} reservations")
            time.sleep(0.05)
        return self.reservations.get()

    def stop(self):
        self.done.set()
        self._closing.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class Client(MessageSocket):
    """Node-side rendezvous client."""

    # pure queries may be replayed on a fresh connection; REG, STOP and
    # PDONE change state and must not be
    IDEMPOTENT = frozenset({"QUERY", "QINFO", "PQUERY"})

    def __init__(self, server_addr):
        self.server_addr = (server_addr[0], int(server_addr[1]))
        self._sock = self._connect()

    def _connect(self):
        last = None
        for attempt in range(MAX_RETRIES):
            try:
                return socket.create_connection(self.server_addr, timeout=30)
            except OSError as e:
                last = e
                time.sleep(2 ** attempt)
        raise ConnectionError(f"cannot reach rendezvous server at "
                              f"{self.server_addr}: {last}")

    def _call(self, msg):
        err = None
        try:
            self.send(self._sock, msg)
            reply = self.receive(self._sock)
        except OSError as e:
            reply, err = None, e
        if reply is not None:
            return reply
        if msg.get("type") not in self.IDEMPOTENT:
            raise ConnectionError("rendezvous server closed connection"
                                  + (f" ({err})" if err else ""))
        logger.warning("rendezvous connection lost during %s; reconnecting",
                       msg.get("type"))
        self.close()
        self._sock = self._connect()
        try:
            self.send(self._sock, msg)
            reply = self.receive(self._sock)
        except OSError as e:
            raise ConnectionError("rendezvous server closed connection") \
                from e
        if reply is None:
            raise ConnectionError("rendezvous server closed connection")
        return reply

    def register(self, node_meta, epoch=0):
        if epoch:
            raise NotImplementedError("cluster epochs come with ROADMAP.md "
                                      "queue 1, item 15")
        faults.check("rendezvous.register")
        return self._call({"type": "REG", "data": node_meta})

    def get_reservations(self):
        return self._call({"type": "QINFO"})["data"]

    def partition_done(self, feed, part):
        """Record partition ``part`` of ``feed`` as fully consumed."""
        return self._call({"type": "PDONE", "feed": str(feed),
                           "part": int(part)})

    def fed_partitions(self, feed="input"):
        return self._call({"type": "PQUERY", "feed": str(feed)})["data"]

    def await_reservations(self, timeout=DEFAULT_TIMEOUT):
        """Poll until the cluster is complete, then return every node's
        metadata."""
        deadline = time.time() + timeout
        while True:
            faults.check("rendezvous.query")
            if self._call({"type": "QUERY"})["data"]:
                break
            if time.time() > deadline:
                raise TimeoutError("timed out awaiting cluster completion")
            # jittered, so nodes registering together do not poll in step
            time.sleep(POLL_SECS * (0.5 + random.random()))
        return self.get_reservations()

    def request_stop(self):
        try:
            return self._call({"type": "STOP"})
        finally:
            self.close()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
