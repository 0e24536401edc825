"""What the port's CLIs share: the device check and a run's logger."""

from __future__ import annotations

import logging
import os

import torch


def require_device(name: str) -> torch.device:
    """The torch device of a --device choice; 'cuda' without a card raises."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
    return torch.device(name)


def run_logger(log_dir: str, name: str) -> logging.Logger:
    """A logger of one run: to the console and to log_dir/log.txt (the
    caller closes and removes its handlers when the run ends)."""
    logger = logging.getLogger(f"{name}.{log_dir}")
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(f"[%(asctime)s::{name}] %(message)s")
    for handler in (logging.StreamHandler(), logging.FileHandler(os.path.join(log_dir, "log.txt"))):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger
