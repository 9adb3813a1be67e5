"""Local ranks of a process group, started as subprocesses on a free port.

Binding port 0 and closing the socket finds a port free only for a moment:
that port lies in the kernel's ephemeral range, from which every other
process's bind to port 0 draws. Under a parallel test run (``-n 6``),
other workers' gloo pairs and rendezvous servers bind such ports all the
time, and one may take the port before rank 0's store binds it. Rank 0
then fails with EADDRINUSE while the other ranks wait for a store that
never comes. So ``free_port`` picks a port below the ephemeral range,
which only an explicit bind takes, and ``start_ranks`` waits for rank 0
first and, should it still lose its port, stops the others and starts
them all again on a fresh one.
"""

import random
import socket
import subprocess
from typing import Callable, List, Optional, Sequence, Tuple

ADDRESS_IN_USE = ("EADDRINUSE", "address already in use")
EPHEMERAL = "/proc/sys/net/ipv4/ip_local_port_range"


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def free_port() -> int:
    """A local port that nothing had bound a moment ago: a random one
    between 10000 and the ephemeral range, else (no such range known, or
    none free in 100 draws) one that binding port 0 gives."""
    try:
        with open(EPHEMERAL) as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 0
    for _ in range(100 if low > 11000 else 0):
        port = random.randrange(10000, low)
        if _bindable(port):
            return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        p.kill()
        p.communicate()


def start_ranks(start: Callable[[int], List[subprocess.Popen]],
                timeout: float, attempts: int = 5
                ) -> List[Tuple[int, str, Optional[str]]]:
    """(returncode, stdout, stderr) of each rank that ``start(port)``
    starts, rank 0 first, with text-mode pipes. Each rank may take
    ``timeout`` seconds; one that takes longer is killed with the others
    and ``subprocess.TimeoutExpired`` raised. If rank 0 fails, the others
    are stopped (they would wait for it); if it failed because another
    process held the port, the ranks start again on a fresh one, up to
    ``attempts`` times in all."""
    for attempt in range(1, attempts + 1):
        procs = start(free_port())
        try:
            out, err = procs[0].communicate(timeout=timeout)
            results = [(procs[0].returncode, out, err)]
            if procs[0].returncode != 0:
                _stop(procs[1:])
                lost = any(m in (out or "") + (err or "")
                           for m in ADDRESS_IN_USE)
                if lost and attempt < attempts:
                    continue
                return results + [(p.returncode, "", "") for p in procs[1:]]
            for p in procs[1:]:
                out, err = p.communicate(timeout=timeout)
                results.append((p.returncode, out, err))
            return results
        except subprocess.TimeoutExpired:
            _stop(procs)
            raise
