"""tests/torch_ranks.py, which starts the gloo ranks of the port's
multi-process tests: its port lies below the kernel's ephemeral range, and
a start whose rank 0 loses the port to another process is made again."""

import subprocess
import sys

from tests.torch_ranks import EPHEMERAL, free_port, start_ranks

SLEEP = "import time; time.sleep(120)"


def popen(code):
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_free_port_lies_below_the_ephemeral_range():
    with open(EPHEMERAL) as f:
        low = int(f.read().split()[0])
    for _ in range(20):
        assert 10000 <= free_port() < low


def test_ranks_start_again_when_rank_0_loses_its_port():
    """Rank 0 reports EADDRINUSE (as a TCPStore server that cannot listen
    does): the waiting rank is stopped and both start again on a fresh
    port, whose run is returned."""
    ports = []

    def start(port):
        ports.append(port)
        if len(ports) == 1:
            return [popen("import sys; sys.exit('code: -98, name: "
                          "EADDRINUSE, message: address already in use')"),
                    popen(SLEEP)]
        return [popen(f"print('rank 0 on', {port})"), popen("print('rank 1')")]

    results = start_ranks(start, timeout=60)
    assert len(ports) == 2
    assert [(code, out.strip()) for code, out, _ in results] == [
        (0, f"rank 0 on {ports[1]}"), (0, "rank 1")]


def test_another_rank_0_failure_is_returned_at_once():
    """Rank 0 fails for another reason: no second start, the other ranks
    stopped rather than waited for, rank 0's error returned."""
    ports = []

    def start(port):
        ports.append(port)
        return [popen("raise SystemExit('the model diverged')"),
                popen(SLEEP)]

    results = start_ranks(start, timeout=60)
    assert len(ports) == 1
    assert results[0][0] == 1 and "the model diverged" in results[0][2]
    assert results[1][0] != 0
