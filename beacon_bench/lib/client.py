"""The load of the closed loop: one process, one thread, every keep-alive
client a non-blocking socket of one event loop, each client sending its
next request when its last one has answered. Standard library only: it
imports neither torch nor the program, so it takes nothing from the
server's interpreter, and it adds one thread to the host, not one a
client.

    python beacon_bench/lib/client.py

Protocol, one JSON document a line. In on stdin: ``{"port", "lists":
[[[id, method, path, body], ...] a client]}``; then ``{"go": true}``,
upon which every client sends its list in order; then ``{"t1"}`` on the
``time.monotonic`` clock (one clock for every process of the host),
after which no client starts a request at or after ``t1`` (the end of
stdin stops them at once). Out on stdout: ``ready`` once connected; at
the end, ``{"rows": [[id, t_send, t_done, status, body], ...],
"errors": [...]}`` (a client that used up its list before ``t1``
reports it).

Each client keeps one persistent HTTP/1.1 connection; a request whose
connection fails before its answer is sent once more over a fresh one
(as ``sbeacon_tpu_torch.harness.latency.Client`` does), and a second
failure, or no answer within ``TIMEOUT_S``, is a row of status 0.
"""

from __future__ import annotations

import json
import os
import selectors
import socket
import sys
import time

TIMEOUT_S = 300.0


class Conn:
    """One client: its connection, its list and the request in flight."""

    def __init__(self, port: int, mine: list):
        self.port = port
        self.mine = mine
        self.next = 0
        self.sock = None
        self.out = b""
        self.buf = bytearray()
        self.need = None  # header length + body length, once known
        self.status = 0
        self.cur = None  # (rid, method, path, body, t_send, attempt)
        self.done = False

    def connect(self):
        s = socket.create_connection(("127.0.0.1", self.port))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.setblocking(False)
        self.sock = s

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def encode(self, method: str, path: str, body) -> bytes:
        data = body.encode() if isinstance(body, str) else (body or b"")
        head = [f"{method} {path} HTTP/1.1",
                f"Host: 127.0.0.1:{self.port}",
                "Accept-Encoding: identity"]
        if data:
            head += ["Content-Type: application/json",
                     f"Content-Length: {len(data)}"]
        return ("\r\n".join(head) + "\r\n\r\n").encode() + data

    def parse(self) -> bool:
        """Whether ``buf`` holds a whole answer (status and length read
        from its head once that has come)."""
        if self.need is None:
            end = self.buf.find(b"\r\n\r\n")
            if end < 0:
                return False
            lines = bytes(self.buf[:end]).decode("latin-1").split("\r\n")
            self.status = int(lines[0].split()[1])
            length = 0
            for line in lines[1:]:
                k, _, v = line.partition(":")
                if k.strip().lower() == "content-length":
                    length = int(v.strip())
            self.need = end + 4 + length
        return len(self.buf) >= self.need


class Loop:
    def __init__(self, port: int, lists: list, stdin: bytes = b""):
        self.sel = selectors.DefaultSelector()
        self.conns = [Conn(port, mine) for mine in lists]
        self.stop = float("inf")
        self.rows, self.errors = [], []
        self.stdin = stdin
        self.stdin_open = True

    def start_next(self, c: Conn):
        """Send ``c``'s next request, or retire it."""
        now = time.monotonic()
        if now >= self.stop:
            c.done = True
        elif c.next >= len(c.mine):
            self.errors.append("request list used up before the window "
                               "closed")
            c.done = True
        else:
            rid, method, path, body = c.mine[c.next]
            c.next += 1
            try:
                self.send(c, (rid, method, path, body, now, 0))
            except OSError as e:
                self.fail(c, e)
            return
        if c.done:
            self.unwatch(c)
            c.close()

    def send(self, c: Conn, cur):
        c.cur = cur
        c.buf = bytearray()
        c.need = None
        c.out = c.encode(cur[1], cur[2], cur[3])
        if c.sock is None:
            c.connect()
        self.watch(c, selectors.EVENT_WRITE)

    def watch(self, c: Conn, events: int):
        try:
            self.sel.modify(c.sock, events, c)
        except KeyError:
            self.sel.register(c.sock, events, c)

    def unwatch(self, c: Conn):
        if c.sock is not None:
            try:
                self.sel.unregister(c.sock)
            except KeyError:
                pass

    def finish(self, c: Conn, status: int, data: bytes):
        rid, _m, _p, _b, ts, _a = c.cur
        self.rows.append([rid, ts, time.monotonic(), status,
                          data.decode("utf-8", "replace")])
        c.cur = None
        self.start_next(c)

    def fail(self, c: Conn, err: Exception):
        """A connection failed before the answer: once more over a fresh
        connection, then a row of status 0."""
        self.unwatch(c)
        c.close()
        rid, method, path, body, ts, attempt = c.cur
        c.cur = None
        if attempt == 0 and not isinstance(err, TimeoutError):
            try:
                self.send(c, (rid, method, path, body, ts, 1))
                return
            except OSError as e:
                err = e
        self.finish(c, 0, repr(err).encode())

    def on_event(self, c: Conn, mask: int):
        try:
            if mask & selectors.EVENT_WRITE and c.out:
                sent = c.sock.send(c.out)
                c.out = c.out[sent:]
                if not c.out:
                    self.watch(c, selectors.EVENT_READ)
                return
            chunk = c.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("connection closed before the answer")
            c.buf += chunk
            if c.parse():
                body = bytes(c.buf[c.buf.find(b"\r\n\r\n") + 4:c.need])
                self.finish(c, c.status, body)
        except (BlockingIOError, InterruptedError):
            return
        except (OSError, ValueError, IndexError) as e:
            self.fail(c, e)

    def read_stdin(self):
        chunk = os.read(0, 1 << 16)
        if not chunk:
            self.stdin_open = False
            self.sel.unregister(0)
            self.stop = min(self.stop, time.monotonic())
            return
        self.stdin += chunk
        self.take_lines()

    def take_lines(self):
        while b"\n" in self.stdin:
            line, _, self.stdin = self.stdin.partition(b"\n")
            if line.strip():
                self.stop = json.loads(line)["t1"]

    def run(self):
        self.sel.register(0, selectors.EVENT_READ, None)
        self.take_lines()
        for c in self.conns:
            self.start_next(c)
        while any(not c.done for c in self.conns):
            for key, mask in self.sel.select(timeout=0.5):
                if key.data is None:
                    self.read_stdin()
                else:
                    self.on_event(key.data, mask)
            now = time.monotonic()
            for c in self.conns:
                if c.cur is not None and now - c.cur[4] > TIMEOUT_S:
                    self.fail(c, TimeoutError("no answer in time"))
        if self.stdin_open:
            self.sel.unregister(0)
        self.sel.close()


def read_line(rest: bytes) -> tuple[bytes, bytes]:
    """The next line of stdin, read from its descriptor (no buffer of
    its own that the loop would not see), and what came after it."""
    while b"\n" not in rest:
        chunk = os.read(0, 1 << 20)
        if not chunk:
            raise EOFError("stdin closed")
        rest += chunk
    line, _, rest = rest.partition(b"\n")
    return line, rest


def main() -> int:
    line, rest = read_line(b"")
    job = json.loads(line)
    loop = Loop(job["port"], job["lists"])
    for c in loop.conns:
        c.connect()
    print("ready", flush=True)
    _go, rest = read_line(rest)
    loop.stdin = rest
    loop.run()
    json.dump({"rows": loop.rows, "errors": loop.errors}, sys.stdout)
    sys.stdout.write("\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
