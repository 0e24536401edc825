"""Weight bridge between the JAX package's flax parameters and this port.

The port's modules carry the reference TargetDiff parameter names, so the
mapping of targetdiff_tpu/utils/port.py (reference state_dict -> flax) read
backwards turns a flax parameter tree into the port's state_dict:
  protein_atom_emb / ligand_atom_emb / v_inference_{0,2}: kernel^T -> weight
  refine_net.edge_pred_layer.{lin_0,norm_0,lin_1} -> .net.{0,1,3}
  refine_net.block_{l}.{x2h_0,h2x_0}.* -> refine_net.base_block.{l}.{x2h,h2x}_layers.0.*
  ew_net -> ew_net.0, LayerNorm scale -> weight.
`state_dict_to_flax_params` is the inverse, for writing checkpoints the JAX
package reads. `load_npz_params` reads a targetdiff_tpu checkpoint
(utils/checkpoint.py) with numpy alone.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config

_SEGMENT = [
    (re.compile(r"^block_(\d+)$"), r"base_block.\1"),
    (re.compile(r"^(x2h|h2x)_(\d+)$"), r"\1_layers.\2"),
    (re.compile(r"^v_inference_(\d+)$"), r"v_inference.\1"),
    (re.compile(r"^lin_0$"), "net.0"),
    (re.compile(r"^norm_0$"), "net.1"),
    (re.compile(r"^lin_1$"), "net.3"),
    (re.compile(r"^ew_net$"), "ew_net.0"),
]


def _walk(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def flax_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """{'params': nested flax tree of arrays} (or the inner tree) -> the
    port's state_dict; the exact inverse of
    targetdiff_tpu.utils.port.torch_state_dict_to_flax."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, leaf in _walk(tree):
        *mods, leaf_name = path
        names = []
        for seg in mods:
            for pat, rep in _SEGMENT:
                if pat.match(seg):
                    seg = pat.sub(rep, seg)
                    break
            names.append(seg)
        arr = np.asarray(leaf)
        if leaf_name == "kernel":
            leaf_name, arr = "weight", arr.T
        elif leaf_name == "scale":
            leaf_name = "weight"
        out[".".join(names + [leaf_name])] = torch.tensor(arr)
    return out


_PAIR = {"base_block": "block_{}", "x2h_layers": "x2h_{}", "h2x_layers": "h2x_{}",
         "v_inference": "v_inference_{}"}
_MLP = {"0": "lin_0", "1": "norm_0", "3": "lin_1"}


def state_dict_to_flax_params(state_dict) -> Dict:
    """The port's state_dict -> {'params': nested flax tree of numpy arrays};
    the inverse of `flax_params_to_state_dict`."""
    tree: Dict = {}
    for name, tensor in state_dict.items():
        toks = name.split(".")
        segs, i = [], 0
        while i < len(toks) - 1:
            tok = toks[i]
            if tok in _PAIR:
                segs.append(_PAIR[tok].format(toks[i + 1]))
                i += 2
            elif tok == "net":
                segs.append(_MLP[toks[i + 1]])
                i += 2
            elif tok == "ew_net":
                segs.append("ew_net")
                i += 2
            else:
                segs.append(tok)
                i += 1
        arr = tensor.detach().cpu().numpy()
        leaf = toks[-1]
        if leaf == "weight":
            leaf = "kernel" if arr.ndim == 2 else "scale"
            arr = arr.T if arr.ndim == 2 else arr
        node = tree
        for seg in segs:
            node = node.setdefault(seg, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def load_npz_params(path: str):
    """The `params/...` arrays of a targetdiff_tpu .npz checkpoint as the
    nested tree `flax_params_to_state_dict` takes."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("params/"):
                continue
            node = tree
            *parents, leaf = key[len("params/"):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def load_npz_config(path: str) -> Config:
    """The training config embedded in a checkpoint's `__meta__`: JSON text
    in the port's checkpoints, YAML text in the JAX package's (PyYAML is
    imported for those only)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
    return parse_config_text(meta["config"])


def parse_config_text(text: str) -> Config:
    try:
        return Config(json.loads(text))
    except json.JSONDecodeError:
        import yaml

        return Config(yaml.safe_load(text))
