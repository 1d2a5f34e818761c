"""Per-section wall-clock loop profiler.

Capability parity with the reference's ``utils.LoopProfiler``
(utils.py:159-200): context-manager tags accumulate elapsed milliseconds
per section; every ``dump_freq`` steps the accumulated summary is logged
and reset. Unlike the reference (defined but never wired in), the
harness can enable it with ``RunConfig(profile=True)`` — useful because
device dispatch is asynchronous and the tag boundaries make the real
sync points visible.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict


class LoopProfiler:
    class Tag:
        def __init__(self, name, line, prof):
            self.name, self.line, self.prof = name, line, prof

        def elapsed(self) -> float:
            return (time.time() - self.updated) * 1000.0

        def __enter__(self):
            self.updated = time.time()
            extra = "" if self.line is None else ": " + self.line
            self.prof.log.debug("(( '%s'%s", self.name, extra)
            return self

        def __exit__(self, typ, value, traceback):
            ms = self.elapsed()
            self.prof.log.debug("    elapsed[%d] ))", int(ms))
            self.prof.tags[self.name] = self.prof.tags.get(self.name, 0.0) + ms

    def __init__(self, log=None, dump_freq: int = 10):
        self.log = log or logging.getLogger("profiler")
        self.dump_freq = dump_freq
        self.tags = OrderedDict()
        self.step_count = 0

    def __enter__(self):
        return self

    def start(self, line=None):
        self.step_count += 1
        if line is not None:
            self.log.debug(line)
        return self

    def tag(self, name, line=None) -> "LoopProfiler.Tag":
        return LoopProfiler.Tag(name, line, self)

    def __exit__(self, typ, value, traceback):
        if self.dump_freq > 0 and self.step_count % self.dump_freq == 0:
            summary = ", ".join("'%s':%d" % (k, int(v))
                                for k, v in self.tags.items())
            self.log.info("Summary at[%d] for[%d]: [%s]",
                          self.step_count, self.dump_freq, summary)
            for key in self.tags:
                self.tags[key] = 0.0
