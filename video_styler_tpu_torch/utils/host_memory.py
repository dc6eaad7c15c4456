"""The host-side measures of checkpoint loading: the resident set's peak
over a block of code, and a file's pages dropped from the page cache."""
from __future__ import annotations

import os
import threading


class RssPeak:
    """The largest resident set size of this process while the block runs,
    read from /proc/self/status every 5 ms (getrusage's ru_maxrss is the
    whole life's peak, and a sandbox may refuse to reset it through
    /proc/self/clear_refs)."""

    def __enter__(self):
        self.peak = self.now()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()
        return self

    @staticmethod
    def now() -> int:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) * 1024
        return 0

    def _watch(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self.now())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.now())


def drop_from_page_cache(paths):
    """fsync each file and ask the kernel to drop its cached pages, so that
    a load reads the disk as a first load would (advisory: a no-op where the
    file system keeps no page cache of its own)."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
