"""Fault-tolerance supervisor: run, watch, restart-from-checkpoint.

The port's copy of :mod:`repro.launch.supervisor` (pure Python).  Wraps
any launcher subprocess (``python -m repro_torch.launch.reduce``, or
``python -m torch.distributed.run ... -m repro_torch.launch.reduce``).  On
non-zero exit or on a heartbeat stall (straggler / hang mitigation) the job
is killed and relaunched; because checkpoints are atomic and the build
resumes from its newest step, the relaunch lands on the same basis.

    python -m repro_torch.launch.supervisor --max-restarts 3 -- \
        python -m repro_torch.launch.reduce --small --workdir w --resume
"""

from __future__ import annotations

import argparse
import collections
import os
import signal
import subprocess
import sys
import time


def run_supervised(
    cmd: list[str],
    max_restarts: int = 3,
    stall_timeout_s: float | None = None,
    log_path: str | None = None,
    backoff_base_s: float = 0.5,
    backoff_cap_s: float = 30.0,
    restart_window_s: float = 3600.0,
) -> int:
    """Run ``cmd``; restart on crash or output stall.  Returns final rc.

    The restart budget is a SLIDING WINDOW, not a lifetime count: up to
    ``max_restarts`` restarts within any ``restart_window_s`` span.  A
    long-running job that hiccups once a day never exhausts its budget,
    while a crash loop (the lifetime count's real target) still trips it
    within minutes.  Between restarts the supervisor sleeps an exponential
    backoff — ``backoff_base_s * 2**(restarts in window)``, capped at
    ``backoff_cap_s`` — so a crash caused by contended shared state (a
    checkpoint filesystem coming back, a port being released) gets time to
    clear instead of burning the whole budget in one second.  Set
    ``backoff_base_s=0`` to disable the sleep (tests).
    """
    restart_times: collections.deque[float] = collections.deque()
    while True:
        log = open(log_path, "ab") if log_path else None
        proc = subprocess.Popen(
            cmd,
            stdout=log or None,
            stderr=subprocess.STDOUT if log else None,
        )
        last_size = -1
        last_progress = time.time()
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            if stall_timeout_s and log_path:
                size = os.path.getsize(log_path)
                if size != last_size:
                    last_size = size
                    last_progress = time.time()
                elif time.time() - last_progress > stall_timeout_s:
                    print(f"supervisor: stall > {stall_timeout_s}s, killing",
                          file=sys.stderr)
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    rc = -9
                    break
            time.sleep(0.2)
        if log:
            log.close()
        if rc == 0:
            return 0
        now = time.time()
        while restart_times and now - restart_times[0] > restart_window_s:
            restart_times.popleft()
        if len(restart_times) >= max_restarts:
            print(f"supervisor: giving up after {len(restart_times)} "
                  f"restarts in {restart_window_s:.0f}s window",
                  file=sys.stderr)
            return rc
        delay = min(backoff_base_s * (2.0 ** len(restart_times)),
                    backoff_cap_s) if backoff_base_s > 0 else 0.0
        restart_times.append(now)
        print(f"supervisor: rc={rc}; restart "
              f"{len(restart_times)}/{max_restarts} in window"
              + (f" after {delay:.1f}s backoff" if delay else ""),
              file=sys.stderr)
        if delay:
            time.sleep(delay)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget within --restart-window seconds")
    ap.add_argument("--stall-timeout", type=float, default=None)
    ap.add_argument("--log", default=None)
    ap.add_argument("--backoff", type=float, default=0.5,
                    help="base restart backoff seconds (0 disables; "
                         "doubles per restart in the window)")
    ap.add_argument("--backoff-cap", type=float, default=30.0)
    ap.add_argument("--restart-window", type=float, default=3600.0,
                    help="sliding window (s) the restart budget applies to")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    raise SystemExit(
        run_supervised(cmd, args.max_restarts, args.stall_timeout, args.log,
                       backoff_base_s=args.backoff,
                       backoff_cap_s=args.backoff_cap,
                       restart_window_s=args.restart_window)
    )


if __name__ == "__main__":
    main()
