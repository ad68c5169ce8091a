"""Cluster rendezvous: a TCP registry that assembles the job's topology.

An own copy of the part of ``tensorflowonspark_tpu/rendezvous.py`` that
the SPARK-fed training path calls: a ``Server`` on the driver, a
``Client`` in each node, length-prefixed JSON messages (REG, QUERY,
QINFO, STOP, and the feed ledger's PDONE/PQUERY).  What the
registry produces is what ``torch.distributed.init_process_group``
needs: every node's host and reserved port, from which the node runtime
derives the coordinator address, the world size and each rank.

Cluster recovery (``cluster.run(restarts=, min_executors=)``) fences
each incarnation with an epoch: ``Server.reset(epoch)`` drops the
reservations and rejects a REG stamped with an older epoch, and
``Server.resize`` changes how many registrations complete the next
one.  The feed ledger survives both; only ``reset_feed`` clears it.
Env overrides as in the JAX package:
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
from tensorflowonspark_tpu_torch.utils import (
    faults,
    get_ip_address,
    telemetry,
)

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
            eid = meta.get("executor_id") if isinstance(meta, dict) else None
            if eid is not None:
                for i, m in enumerate(self._reservations):
                    if isinstance(m, dict) and m.get("executor_id") == eid:
                        # a node retried within the epoch replaces its
                        # stale reservation instead of duplicating it
                        logger.info("replacing reservation of executor %s",
                                    eid)
                        self._reservations[i] = meta
                        return
            self._reservations.append(meta)

    def reset(self):
        with self._lock:
            self._reservations = []

    def resize(self, required):
        """Change how many registrations complete the cluster (an
        elastic recovery re-forms it over the surviving executors)."""
        with self._lock:
            self.required = int(required)

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
        # the epoch fence: recovery bumps it through reset(); a REG
        # stamped with another epoch is rejected, so a node of an earlier
        # incarnation never takes a seat in the new one
        self.epoch = 0
        # feed ledger: feeders report each fully consumed partition
        self._feeds = DeliveryLedger()

    def reset(self, epoch):
        """Fence a new cluster incarnation: drop the reservations and the
        STOP flag, and reject REGs of any other epoch from now on.  The
        feed ledger survives: it is what lets the re-feed skip the
        partitions already consumed."""
        self.epoch = int(epoch)
        self.reservations.reset()
        self.done.clear()
        telemetry.event("rendezvous/epoch_reset", epoch=self.epoch)
        logger.info("rendezvous: reset to epoch %d", self.epoch)

    def resize(self, required):
        """The next incarnation completes with ``required`` registrations
        (fewer after an executor loss that could not be healed, all of
        them after the pool came back).  Call before ``reset(epoch)``."""
        old = self.reservations.required
        self.reservations.resize(required)
        telemetry.event("rendezvous/resize", from_required=old,
                        to_required=int(required))
        logger.info("rendezvous: required registrations %d -> %d", old,
                    int(required))

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
            epoch = int(msg.get("epoch", 0))
            if epoch != self.epoch:
                logger.warning("rejecting registration from epoch %d "
                               "(current %d): %s", epoch, self.epoch,
                               msg.get("data"))
                self.send(sock, {"type": "REJECT",
                                 "data": {"epoch": self.epoch}})
                return
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
        elif kind == "QNUM":
            self.send(sock, {"type": "QNUM",
                             "data": self.reservations.remaining()})
        elif kind == "STOP":
            self.done.set()  # before the reply: an acknowledged STOP holds
            self.send(sock, {"type": "OK"})
        else:
            self.send(sock, {"type": "ERR",
                             "data": f"unknown message {kind!r}"})

    def await_reservations(self, status=None, timeout=DEFAULT_TIMEOUT):
        """Block until every node registered.  ``status`` is the driver's
        shared dict; an 'error' set by the launcher thread aborts."""
        with telemetry.span("rendezvous/await_reservations",
                            required=self.reservations.required) as sp:
            deadline = time.time() + timeout
            while not self.reservations.done():
                if status and status.get("error"):
                    raise RuntimeError(
                        f"node startup failed: {status['error']}")
                if time.time() > deadline:
                    raise TimeoutError(
                        f"timed out waiting for "
                        f"{self.reservations.remaining()} of "
                        f"{self.reservations.required} reservations")
                time.sleep(0.05)
            got = self.reservations.get()
            sp.add(registered=len(got))
            return got

    def stop(self):
        self.done.set()
        self._closing.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class Client(MessageSocket):
    """Node-side rendezvous client."""

    # pure queries may be replayed on a fresh connection; REG, STOP and
    # PDONE change state and must not be
    IDEMPOTENT = frozenset({"QUERY", "QINFO", "QNUM", "PQUERY"})

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
        """Register this node, stamped with its cluster epoch.  A REJECT
        (the cluster recovered past this node's incarnation) raises, so
        the task that hosts the node dies."""
        meta = node_meta if isinstance(node_meta, dict) else {}
        with telemetry.span("rendezvous/register", job=meta.get("job_name"),
                            task=meta.get("task_index"), epoch=epoch):
            faults.check("rendezvous.register")
            reply = self._call({"type": "REG", "data": node_meta,
                                "epoch": int(epoch)})
            if reply.get("type") == "REJECT":
                raise RuntimeError(
                    f"rendezvous registration rejected: node epoch {epoch} "
                    f"!= cluster epoch {reply['data']['epoch']} (stale node "
                    "from a previous cluster incarnation)")
            return reply

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
        with telemetry.span("rendezvous/await_cluster_spec") as sp:
            deadline = time.time() + timeout
            polls = 0
            while True:
                faults.check("rendezvous.query")
                if self._call({"type": "QUERY"})["data"]:
                    break
                polls += 1
                if time.time() > deadline:
                    raise TimeoutError("timed out awaiting cluster "
                                       "completion")
                # jittered, so nodes registering together do not poll in
                # step
                time.sleep(POLL_SECS * (0.5 + random.random()))
            sp.add(polls=polls)
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
