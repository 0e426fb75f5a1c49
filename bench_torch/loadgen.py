"""The load generator of the serving cells, driven by a traffic file.

A traffic file gives the loop (``closed``: one connection, one request in
flight ahead of the read; ``open``: requests sent on a schedule whatever
the replies), the request sizes (``fixed``, or ``min``-``max`` faces with
P(n) ∝ n^-``power``), the rate of an open loop, and ``base_seed``. The
sizes and gaps between arrivals come from ``base_seed``, so every run
seed replays the same schedule; the faces of each request come from the
run seed, drawn from the benchmark's crops.
"""

from __future__ import annotations

import math
import queue
import socket
import threading
import time

import numpy as np

from bench_torch.client import payload, read_response


class Request:
    __slots__ = ("faces", "data", "due", "sent", "done", "reply", "error")

    def __init__(self, faces, due=0.0):
        self.faces, self.due = faces, due
        self.data = None
        self.sent = self.done = None
        self.reply = self.error = None


def _sizes(traffic: dict, rng, n: int) -> np.ndarray:
    s = traffic["sizes"]
    if "fixed" in s:
        return np.full(n, s["fixed"])
    k = np.arange(s["min"], s["max"] + 1)
    p = k.astype(float) ** -s["power"]
    return rng.choice(k, size=n, p=p / p.sum())


def open_schedule(traffic: dict, seconds: float, seed: int, n_pool: int,
                  pool=None):
    """Requests of an open loop: ``round(rate · seconds)`` Poisson arrivals
    in [0, seconds) (sorted uniform points) and their sizes, all from
    ``base_seed``, so that every run seed replays the same schedule; the
    faces of each request come from ``seed``. With ``pool``, each
    request's bytes are made now."""
    base = np.random.default_rng(traffic["base_seed"])
    n = max(1, round(traffic["rate_per_s"] * seconds))
    due = np.sort(base.uniform(0, seconds, n))
    sizes = _sizes(traffic, base, n)
    rng = np.random.default_rng(seed)
    reqs = [Request(rng.integers(0, n_pool, k), d) for k, d in zip(sizes, due)]
    if pool is not None:
        for r in reqs:
            r.data = payload(pool[r.faces])
    return reqs


def closed_ring(traffic: dict, seed: int, n_pool: int):
    """The distinct requests a closed loop cycles through."""
    rng = np.random.default_rng(seed)
    sizes = _sizes(traffic, np.random.default_rng(traffic["base_seed"]),
                   traffic["ring"])
    return [rng.integers(0, n_pool, k) for k in sizes]


def connect(path: str, deadline: float, alive=lambda: True) -> socket.socket:
    """Connect to the server's unix socket once it listens; give up at
    ``deadline`` or when ``alive()`` says the server has gone."""
    while True:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(path)
            return s
        except (FileNotFoundError, ConnectionRefusedError):
            s.close()
            if time.time() > deadline or not alive():
                raise
            time.sleep(0.2)


def run_closed(sock, ring: list, pool: np.ndarray, seconds: float,
               timeout: float) -> tuple:
    """One connection, one request in flight ahead of the read (the
    pattern of the program's ``EmbeddingClient.embed_stream``): request
    i + 1 is sent while reply i is read, from a writer thread, so neither
    side's socket buffer can hold the other up; requests are sent while
    the window is open. Returns (requests, t0, t_end) on the host clock
    (``time.time``)."""
    payloads = [payload(pool[f]) for f in ring]
    sock.settimeout(timeout)
    outbox: "queue.Queue" = queue.Queue()
    failed = threading.Event()

    def writer():
        while (i := outbox.get()) is not None:
            if failed.is_set():
                continue
            try:
                sock.sendall(payloads[i % len(ring)])
            except OSError:
                failed.set()

    th = threading.Thread(target=writer, daemon=True)
    th.start()
    done, t0 = [], time.time()
    i = 0
    outbox.put(i)
    while True:
        r = Request(ring[i % len(ring)])
        more = time.time() - t0 < seconds
        if more:
            outbox.put(i + 1)
        try:
            r.reply = read_response(sock)
            r.done = time.time()
        except (OSError, RuntimeError) as e:
            r.error = repr(e)
            failed.set()
        done.append(r)
        if not more or r.error is not None:
            break
        i += 1
    t_end = time.time()
    outbox.put(None)
    th.join(timeout=timeout)
    return done, t0, t_end


def run_open(sock, reqs: list, seconds: float, timeout: float,
             t0: float) -> list:
    """Put each request at ``t0 + due`` from a thread into a queue that a
    second thread writes to the connection (so a server that stops
    reading does not hold the schedule back), read the replies in order
    here; every request gets ``done`` or ``error``. The requests' bytes
    are made beforehand (``open_schedule(..., pool)``)."""
    sock.settimeout(timeout)
    failed = threading.Event()
    outbox: "queue.Queue" = queue.Queue()

    def timer():
        for r in reqs:
            wait = t0 + r.due - time.time()
            if wait > 0:
                time.sleep(wait)
            r.sent = time.time()
            outbox.put(r)
        outbox.put(None)

    def writer():
        while (r := outbox.get()) is not None:
            if failed.is_set():
                continue
            try:
                sock.sendall(r.data)
            except OSError as e:
                r.error = repr(e)
                failed.set()

    threads = [threading.Thread(target=f, daemon=True) for f in (timer, writer)]
    for th in threads:
        th.start()
    for r in reqs:
        if failed.is_set():
            break
        try:
            r.reply = read_response(sock)
            r.done = time.time()
        except (OSError, RuntimeError) as e:
            r.error = repr(e)
            failed.set()
            break
    failed.set()
    for th in threads:
        th.join(timeout=timeout + seconds)
    for r in reqs:
        if r.done is None and r.error is None:
            r.error = "not answered"
        r.data = None
    return reqs


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q ≤ 1) by nearest rank; inf counts as missing
    every limit."""
    v = sorted(values)
    return float(v[max(0, math.ceil(q * len(v)) - 1)]) if v else float("inf")
