"""Logging setup: stdout + per-run logfile (reference utils.py:38-47)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def set_logging(output_dir: str, log_file_name: Optional[str], level: str = "info"):
    """Log to stdout and, unless `log_file_name` is None (a data-parallel
    rank other than 0), to `output_dir/log_file_name`."""
    os.makedirs(output_dir, exist_ok=True)
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_file_name is not None:
        handlers.append(logging.FileHandler(os.path.join(output_dir, log_file_name)))
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        handlers=handlers,
        force=True,
    )
