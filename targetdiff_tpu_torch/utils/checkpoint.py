"""Checkpoints with resume, counterpart of targetdiff_tpu/utils/checkpoint.py
(reference: scripts/train_diffusion.py:221-228 saves {config, model,
optimizer, scheduler, iteration}).

The file is the JAX package's .npz layout: `params/...` leaves under the
flax names (`utils/port.py:state_dict_to_flax_params`), so the JAX
`load_checkpoint` reads the port's checkpoints, and `__meta__` with the
config as JSON text (valid YAML for the JAX side; the port needs no PyYAML
to save or to load its own). The optimizer state goes under `opt/` in the
port's own layout (torch's Adam state per parameter index), read back only
by the port.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .port import (flax_params_to_state_dict, load_npz_params, parse_config_text,
                   state_dict_to_flax_params)


def _flatten(tree, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def save_checkpoint(path: str, config, net: torch.nn.Module, optimizer=None,
                    scheduler_state: Optional[dict] = None, iteration: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Write `net`'s parameters (flax names), the optimizer state and the
    run metadata to `path` atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = _flatten(state_dict_to_flax_params(net.state_dict()), "params/")
    opt_groups = None
    if optimizer is not None:
        sd = optimizer.state_dict()
        for idx, st in sd["state"].items():
            for k, v in st.items():
                blob[f"opt/state/{idx}/{k}"] = torch.as_tensor(v).detach().cpu().numpy()
        opt_groups = sd["param_groups"]
    meta = {
        "config": json.dumps(config),
        "iteration": int(iteration),
        "scheduler": scheduler_state or {},
        "extra": extra or {},
        "opt_param_groups": opt_groups,
    }
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **blob)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """Returns config (Config), iteration, scheduler, extra, state_dict (the
    port's names, tensors on `device`) and opt_state (a torch optimizer
    state_dict on the host, or None: the optimizer's load_state_dict moves
    it to its parameters' device)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    opt_state: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        for key in z.files:
            if key.startswith("opt/state/"):
                idx, name = key[len("opt/state/"):].split("/")
                opt_state.setdefault(int(idx), {})[name] = torch.from_numpy(z[key])
    sd = {k: v.to(device) for k, v in flax_params_to_state_dict(load_npz_params(path)).items()}
    groups = meta.get("opt_param_groups")
    return {
        "config": parse_config_text(meta["config"]),
        "iteration": meta["iteration"],
        "scheduler": meta.get("scheduler", {}),
        "extra": meta.get("extra", {}),
        "state_dict": sd,
        "opt_state": None if groups is None else {"state": opt_state, "param_groups": groups},
    }
