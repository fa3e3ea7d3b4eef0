"""A closed loop of clients on a batching service, in-process.

`clients` threads each call `service.generate(n, seed)` back to back: a
client sends its next request when the last one has returned.  The window
opens when the clients are released together; a client sends no request
once `seconds` have passed since then; the window closes when the last
request sent has returned.  The k-th request sent in the window carries the
seed base + k, where base is drawn from the run's seed, so every seed is
distinct and a run's seed fixes them all.

The traffic file's parameters: service_batch, clients, n, linger_ms (the
service's), timeout_s (a request not answered by then has failed) and
trace_batches (how many batches a traced run profiles, after the first)."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Record:
    seed: int
    sent: float             # perf_counter seconds
    done: float
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


@dataclasses.dataclass
class Window:
    opened: float
    closed: float
    records: List[Record]

    @property
    def seconds(self) -> float:
        return self.closed - self.opened


def seed_base(seed: int) -> int:
    """The first request seed of a run: below 2^31 - 2^24, so that every
    request seed of a run fits 31 bits."""
    ss = np.random.SeedSequence([int(seed) % 2**64 >> 32, int(seed) % 2**32, 0x5EED])
    return int(ss.generate_state(1, np.uint64)[0] % np.uint64(2**31 - 2**24))


def run(service, traffic: dict, seconds: float, seed: int) -> Window:
    """Drive `service` for one window."""
    base = seed_base(seed)
    counter = iter(range(1 << 24))
    lock = threading.Lock()
    start = threading.Event()
    records: List[Record] = []
    opened = [0.0]
    n, timeout = int(traffic["n"]), float(traffic["timeout_s"])

    def client():
        start.wait()
        mine = []
        while time.perf_counter() - opened[0] < seconds:
            with lock:
                s = base + next(counter)
            sent = time.perf_counter()
            try:
                out = service.generate(n=n, seed=s, timeout=timeout)
                mine.append(Record(s, sent, time.perf_counter(), result=out))
            except Exception as e:  # a failed request is counted, the client goes on
                mine.append(Record(s, sent, time.perf_counter(), error=e))
        with lock:
            records.extend(mine)

    threads = [threading.Thread(target=client, daemon=True) for _ in range(int(traffic["clients"]))]
    for t in threads:
        t.start()
    opened[0] = time.perf_counter()
    start.set()
    for t in threads:
        t.join(timeout + seconds + 60)
    alive = sum(t.is_alive() for t in threads)
    if alive:
        raise RuntimeError(f"{alive} client(s) still waiting after the window")
    records.sort(key=lambda r: r.seed)
    closed = max((r.done for r in records), default=opened[0])
    return Window(opened[0], closed, records)
