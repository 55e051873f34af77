"""closed: a closed loop of one executor task slot.

    "loop": {"kind": "closed", "slots": 1, "depth": 2, "order": "in_turn"}

Tasks are issued back to back over the task partitions in turn; with
depth d, task i+d-1 is dispatched before task i's rows are pulled (depth 2
is how Blaze's driver keeps one slot fed: the next partition is dispatched
before the last one's result is pulled). The loop issues tasks until the
window's seconds have passed (or `count` tasks), then drains those in
flight. Several slots (threads, or the supervisor's pool) or another order
are a loop of their own, loops/<kind>.py; this one refuses them.
"""

import collections
import time

from portbench import task as T


def validate(loop: dict) -> None:
    if int(loop.get("slots", 1)) != 1:
        raise ValueError(f"loop 'closed' runs one slot, not "
                         f"{loop['slots']}: several slots are a loop file "
                         f"of their own")
    if int(loop.get("depth", 1)) < 1:
        raise ValueError(f"loop depth {loop['depth']} is under 1")
    if loop.get("order", "in_turn") != "in_turn":
        raise ValueError(f"loop 'closed' issues partitions in turn, not "
                         f"{loop['order']!r}")


def run(prep, seconds: float, win: T.Window, count=None) -> T.Window:
    validate(prep.loop)
    depth = int(prep.loop.get("depth", 1))
    parts = prep.partitions
    in_flight = collections.deque()
    win.t_start = time.perf_counter()
    deadline = win.t_start + seconds
    i = 0
    while (count is None and time.perf_counter() < deadline) or \
            (count is not None and i < count):
        in_flight.append(T.dispatch(prep.tasks, i % parts, parts,
                                    prep.device))
        while len(in_flight) >= depth:
            T.complete(win, in_flight.popleft())
        i += 1
    while in_flight:
        T.complete(win, in_flight.popleft())
    win.t_end = win.tasks[-1].t_done if win.tasks else time.perf_counter()
    return win
