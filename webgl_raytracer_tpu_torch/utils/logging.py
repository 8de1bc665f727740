"""Ring-buffer logger with INFO/WARN/ERROR levels; the port's own copy of
webgl_raytracer_tpu/utils/logging.py (logger.js:1-22)."""

from __future__ import annotations

import sys
import time


class RingLogger:
    def __init__(self, max_lines: int = 50, stream=None, echo: bool = True):
        self.max_lines = max_lines
        self.lines: list[str] = []
        self.stream = stream if stream is not None else sys.stderr
        self.echo = echo

    def _push(self, level: str, message: str) -> None:
        stamp = time.strftime("%H:%M:%S")
        line = f"[{stamp}] {level}{message}"
        self.lines.append(line)
        if len(self.lines) > self.max_lines:
            self.lines = self.lines[-self.max_lines:]
        if self.echo:
            print(line, file=self.stream)

    def info(self, message: str) -> None:
        self._push("", message)

    def warn(self, message: str) -> None:
        self._push("WARN: ", message)

    def error(self, message: str) -> None:
        self._push("ERROR: ", message)

    def text(self) -> str:
        return "\n".join(self.lines)


def create_logger(max_lines: int = 50, echo: bool = True) -> RingLogger:
    return RingLogger(max_lines=max_lines, echo=echo)
