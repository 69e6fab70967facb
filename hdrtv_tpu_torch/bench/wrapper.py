"""Supervised playback-benchmark wrapper — the GUI bench-dialog analog (the
port's copy of ``hdrtv_tpu/bench/wrapper.py``, with the budget kept by a
timer).

The reference wraps its CLI playback benchmark in a Qt dialog
(``gui_playback_benchmark.py``): the benchmark runs as a **QProcess** so a
crash can't take down the app, its stdout streams into the dialog live, the
main window's playback is **locked** for the duration, the run is
**cancelable**, and at completion the dialog parses the **batch CSV** into a
result table (gui_playback_benchmark.py:180-936). This framework is
headless-first, so the same supervision contract is a plain class over a
subprocess:

- child process isolation (own process group; a wedged run is killed by
  group, never by pattern);
- live line streaming through a callback (the "dialog output pane");
- an exclusive playback lock file so a concurrent ``cli convert`` /
  interactive shell on the same machine can refuse to start mid-benchmark
  (the reference's interaction locks, gui_playback_runtime.py:274-411);
- cancel + budget kill: a timer kills the child's group ``budget_s`` after
  the start, whether or not the child prints (a check made only when a line
  arrives would let a silent child outlive its budget);
- batch-CSV parsing into row dicts and a rendered summary table.

Used by ``cli bench --supervised``; testable with an injected argv.
"""

from __future__ import annotations

import csv
import os
import signal
import subprocess
import sys
import threading

__all__ = ["PlaybackBenchmarkWrapper", "playback_lock_path", "is_playback_locked"]


def playback_lock_path() -> str:
    from hdrtv_tpu_torch.utils.env import env_str

    root = env_str("HDRTVNET_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "hdrtv_tpu"
    )
    return os.path.join(root, "playback.lock")


def is_playback_locked() -> bool:
    """True when a supervised benchmark currently holds the playback lock
    (stale locks — dead pid — do not count)."""
    path = playback_lock_path()
    try:
        with open(path) as f:
            pid = int(f.read().strip() or 0)
    except (OSError, ValueError):
        return False
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


class PlaybackBenchmarkWrapper:
    """Run the playback benchmark CLI under supervision.

    Parameters
    ----------
    argv: the child command; defaults to ``python -m hdrtv_tpu_torch.cli bench ...``
        built from ``bench_args``.
    on_line: callback for each child stdout line (live progress pane).
    budget_s: hard wall budget; the child group is SIGKILLed past it.
    """

    def __init__(
        self,
        bench_args: list[str] | None = None,
        *,
        argv: list[str] | None = None,
        on_line=None,
        budget_s: float = 7200.0,
        out_dir: str | None = None,
    ):
        self.argv = argv or [
            sys.executable, "-m", "hdrtv_tpu_torch.cli", "bench", *(bench_args or [])
        ]
        self.on_line = on_line or (lambda line: None)
        self.budget_s = budget_s
        self.out_dir = out_dir
        self.lines: list[str] = []
        self.returncode: int | None = None
        self.canceled = False
        self._proc: subprocess.Popen | None = None

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> int:
        lock = playback_lock_path()
        os.makedirs(os.path.dirname(lock), exist_ok=True)
        with open(lock, "w") as f:
            f.write(str(os.getpid()))
        try:
            return self._run_locked()
        finally:
            try:
                os.remove(lock)
            except OSError:
                pass

    def _run_locked(self) -> int:
        self._proc = subprocess.Popen(
            self.argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True,
        )
        budget = threading.Timer(self.budget_s, self.cancel, args=("budget exceeded",))
        budget.daemon = True
        budget.start()
        try:
            assert self._proc.stdout is not None
            for line in self._proc.stdout:
                line = line.rstrip("\n")
                self.lines.append(line)
                self.on_line(line)
            self.returncode = self._proc.wait()
        finally:
            budget.cancel()
        return self.returncode

    def cancel(self, reason: str = "user cancel") -> None:
        """Kill the child's whole process group (from the budget's timer
        thread, or the caller's)."""
        self.canceled = True
        if self._proc is None or self._proc.poll() is not None:
            return
        self.on_line(f"[wrapper] cancel: {reason}")
        try:
            os.killpg(self._proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            self._proc.kill()

    # -- results -------------------------------------------------------------

    def batch_rows(self) -> list[dict]:
        """Parse the batch CSV the child wrote (the dialog's result table).

        Searches ``out_dir`` (or the child-printed ``batch CSV:`` path) for
        the summary CSV names the bench writes."""
        candidates = []
        for line in self.lines:
            if "batch CSV:" in line:
                candidates.append(line.split("batch CSV:", 1)[1].strip())
        if self.out_dir:
            for name in ("playback_benchmark_summary.csv", "batch_summary.csv", "batch.csv"):
                candidates.append(os.path.join(self.out_dir, name))
        for path in candidates:
            try:
                with open(path, newline="") as f:
                    return list(csv.DictReader(f))
            except OSError:
                continue
        return []

    def render_table(self, rows: list[dict] | None = None) -> str:
        rows = self.batch_rows() if rows is None else rows
        if not rows:
            return "(no batch results)"
        cols = [c for c in ("resolution", "precision", "use_hg", "fps",
                            "fps_1pct_low", "model_ms", "ring_ms", "frames",
                            "dropped") if c in rows[0]]
        widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols}
        out = ["  ".join(c.ljust(widths[c]) for c in cols)]
        out.append("  ".join("-" * widths[c] for c in cols))
        for r in rows:
            out.append("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))
        return "\n".join(out)
