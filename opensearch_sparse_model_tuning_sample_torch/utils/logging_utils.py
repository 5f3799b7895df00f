"""Logging setup: stdout + per-run logfile (reference utils.py:38-47)."""

from __future__ import annotations

import logging
import os
import sys


def set_logging(output_dir: str, log_file_name: str, level: str = "info"):
    os.makedirs(output_dir, exist_ok=True)
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        handlers=[
            logging.StreamHandler(sys.stdout),
            logging.FileHandler(os.path.join(output_dir, log_file_name)),
        ],
        force=True,
    )
