"""Trial runner: time candidates on the device's clock, keep the median,
prune early (counterpart of ``paddle_tpu/tuner/runner.py``).

Every candidate runs once untimed (its first launch: scratch, kernel
load), then is timed ``trials`` times; a trial is ``iters`` launches
back to back between two CUDA events, behind a spin kernel that holds
the device until the host has queued them all, so the events read the
device and not the host's enqueue (the reference waits on
``block_until_ready``, which a torch tensor lacks). The score is the
median. Early pruning: after the first timed trial, a candidate already
slower than ``prune_factor`` x the best median so far is abandoned.

Unlike the reference, a candidate that fails raises: on CUDA a failed
launch can leave the context broken for every later candidate, so a
search never steps over one.
"""
from __future__ import annotations

import statistics
from typing import Any, Callable, Dict, List, Optional, Tuple

#: cycles of the spin kernel a timed trial starts with (about 25 ms at
#: the H100's clocks), and the longer one taken once if the host did not
#: queue the trial's launches within it
SPIN_CYCLES = 50_000_000


def time_once(run: Callable[[], Any], iters: int = 20) -> float:
    """Seconds a call of ``run`` takes on the device: ``iters`` calls
    between two CUDA events behind a spin, divided by ``iters``. Raises
    when the host cannot queue them within the longer spin (the reading
    would be the host's)."""
    import torch
    torch.cuda.synchronize()
    for cycles in (SPIN_CYCLES, 4 * SPIN_CYCLES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        ahead = not start.query()      # the spin still ran: all queued
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / 1e3 / iters
    raise RuntimeError(
        f"tuner: the host did not queue {iters} launches within a spin of "
        f"{4 * SPIN_CYCLES} cycles; the reading would be host time")


def measure(run: Callable[[], Any], trials: int = 5,
            best_so_far: Optional[float] = None,
            prune_factor: float = 2.0, iters: int = 20,
            times: Optional[List[float]] = None) -> Optional[float]:
    """Median-of-``trials`` device seconds a call of ``run`` takes, after
    one untimed call; None when early pruning fires. Each trial's time
    is appended to ``times`` when given. A failing call raises."""
    import torch
    run()
    torch.cuda.synchronize()
    first = time_once(run, iters)
    got = [first]
    if best_so_far is None or first <= best_so_far * prune_factor:
        for _ in range(max(0, trials - 1)):
            got.append(time_once(run, iters))
    if times is not None:
        times.extend(got)
    if len(got) == 1 and trials > 1:
        return None                       # early pruning
    return statistics.median(got)


def search(candidates: List[Any],
           make_runner: Callable[[Any], Callable[[], Any]],
           trials: int = 5, prune_factor: float = 2.0, iters: int = 20,
           rounds: Optional[Dict[str, List[float]]] = None
           ) -> Tuple[Optional[Any], Optional[float], Dict[str, float]]:
    """Time every candidate; returns (winner, winner_seconds, results).

    ``make_runner(candidate)`` returns the zero-arg callable to time.
    ``results`` maps repr(candidate) -> median seconds for the
    candidates not pruned; ``rounds``, when given, gets every timed
    trial of every candidate under the same keys."""
    best: Optional[Any] = None
    best_t: Optional[float] = None
    results: Dict[str, float] = {}
    for cand in candidates:
        run = make_runner(cand)
        times: List[float] = []
        t = measure(run, trials=trials, best_so_far=best_t,
                    prune_factor=prune_factor, iters=iters, times=times)
        if rounds is not None:
            rounds[repr(cand)] = times
        if t is None:
            continue
        results[repr(cand)] = t
        if best_t is None or t < best_t:
            best, best_t = cand, t
    return best, best_t, results
