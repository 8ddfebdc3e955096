"""Logging configuration — the analog of the reference's log4j setup.

The reference configures two appenders in src/main/resources/log4j.properties:
a console appender and a daily-rolling file appender, with the app loggers
(rwLogger/myLogger) at INFO (SURVEY.md §5.5). Here the same shape: a console
handler always, plus a midnight-rolling file handler under --logDir when given.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"
LOG_FILE = "stellar-rw-tpu.log"


def configure(log_dir: str | None = None, level: int = logging.INFO) -> None:
    """Idempotent: repeated calls (tests, job server re-runs) don't stack handlers."""
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter(FORMAT)
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in root.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if log_dir:
        path = os.path.join(log_dir, LOG_FILE)
        have = any(isinstance(h, logging.handlers.TimedRotatingFileHandler)
                   and getattr(h, "baseFilename", None) == os.path.abspath(path)
                   for h in root.handlers)
        if not have:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.handlers.TimedRotatingFileHandler(
                path, when="midnight", backupCount=7)
            fh.setFormatter(fmt)
            root.addHandler(fh)
