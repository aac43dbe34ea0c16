"""Console progress tracking with ETA (likelihood/progress.rs parity).

On the card whole matrices complete in one call, so per-cell
increments are usually synthetic; the tracker still provides the reference's
surface (inc/finish, prints every 1000 items or 5%) for host-side loops
(NCA batches, per-subject drivers).
"""

from __future__ import annotations

import sys
import threading
import time


def format_duration(seconds: float) -> str:
    total = int(seconds)
    hours, rem = divmod(total, 3600)
    minutes, secs = divmod(rem, 60)
    if hours > 0:
        return f"{hours:02d}h:{minutes:02d}m:{secs:02d}s"
    return f"{minutes:02d}m:{secs:02d}s"


class ProgressTracker:
    def __init__(self, total: int, stream=None):
        self.total = int(total)
        self._count = 0
        self._lock = threading.Lock()
        self._start = time.perf_counter()
        self._stream = stream or sys.stdout

    @property
    def count(self) -> int:
        return self._count

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._count += n
            current = self._count
        if self.total == 0:
            return
        if current % 1000 == 0 or (current * 20) % self.total == 0:
            percent = current * 100 // self.total
            elapsed = time.perf_counter() - self._start
            if current > 0:
                eta = elapsed * (self.total / current) - elapsed
                eta_text = format_duration(max(eta, 0.0))
            else:
                eta_text = "calculating..."
            self._stream.write(
                f"\rProgress: {current}/{self.total} ({percent}%) ETA: {eta_text}"
            )
            self._stream.flush()

    def finish(self) -> None:
        self._stream.write("\nSimulation complete!\n")
        self._stream.flush()
