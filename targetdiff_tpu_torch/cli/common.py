"""What the port's CLIs share: the device check, a run's logger and the
multi-process flags."""

from __future__ import annotations

import logging
import os

import torch

from ..parallel import mesh as pmesh


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


def add_dist_args(ap) -> None:
    """The multi-process flags (JAX cli/train_diffusion.py's --dist_*)."""
    ap.add_argument("--dist_coordinator", default=None,
                    help="multi-process: the rendezvous, host:port or file:///path")
    ap.add_argument("--dist_num_processes", type=int, default=None)
    ap.add_argument("--dist_process_id", type=int, default=None)
    ap.add_argument("--dist_backend", default=None, choices=list(pmesh.BACKENDS),
                    help="default nccl on cuda, gloo on cpu; two ranks on one card need gloo")


def multi_process(args) -> bool:
    return args.dist_coordinator is not None or args.dist_num_processes is not None


def start_mesh(args):
    """(device, mesh) of this process: mesh None for one process, else the
    started process group of the --dist_* flags on this rank's device (the
    caller ends the group)."""
    if not multi_process(args):
        return require_device(args.device), None
    device = pmesh.rank_device(args.device, args.dist_process_id or 0)
    backend = args.dist_backend or pmesh.default_backend(device)
    if not pmesh.init_distributed(args.dist_coordinator, args.dist_num_processes,
                                  args.dist_process_id, backend, device):
        return device, None
    return device, pmesh.current_mesh(device)
