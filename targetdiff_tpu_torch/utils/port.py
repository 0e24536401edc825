"""Weight bridge between the JAX package's flax parameters and this port.

The port's modules carry the reference TargetDiff parameter names, so the
mapping of targetdiff_tpu/utils/port.py (reference state_dict -> flax) read
backwards turns a flax parameter tree into the port's state_dict:
  protein_atom_emb / ligand_atom_emb / v_inference_{0,2}: kernel^T -> weight
  an MLP's lin_{i} / norm_{i} -> net.{index in the reference's nn.Sequential}:
    with LayerNorms lin_0, norm_0, lin_1 -> net.0, net.1, net.3
    (refine_net.edge_pred_layer, the attention layers' k/v/q MLPs),
    without them lin_0, lin_1 -> net.0, net.2 (the EGNN layers' edge_mlp and
    node_mlp, which take neither norm nor the act_last LayerNorm)
  refine_net.block_{l}.{x2h_0,h2x_0}.* -> refine_net.base_block.{l}.{x2h,h2x}_layers.0.*
  the EGNN denoiser's refine_net.layer_{l} and a prop model's
    encoder.layer_{l} -> refine_net.net.{l}, encoder.net.{l}
  x_mlp_{0,2} (EGNN), out_{0,2}, enc_node_{0,2} (prop models) -> x_mlp.{0,2}, ...
  ew_net, edge_inf -> ew_net.0, edge_inf.0; LayerNorm scale -> weight;
  refine_net.block_{l}.x2h_{i}.node_output.* (x2h_out_fc) -> ...x2h_layers.{i}.node_output.net.*
  time_emb_l1 / time_emb_l2 -> time_emb.1 / time_emb.3 (the 'sin' time embedding)
  an MLP's Swish_0.beta (act_fn swish; one a flax MLP) -> net.{its first
    activation's index}.beta: net.2 with LayerNorms, net.1 without.
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
    (re.compile(r"^(v_inference|x_mlp|out|enc_node)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^layer_(\d+)$"), r"net.\1"),
    (re.compile(r"^(ew_net|edge_inf)$"), r"\1.0"),
    (re.compile(r"^time_emb_l1$"), "time_emb.1"),
    (re.compile(r"^time_emb_l2$"), "time_emb.3"),
]
_MLP_LEAF = re.compile(r"^(lin|norm)_(\d+)$")
_LAYER_LISTS = ("refine_net", "encoder")  # whose `net` is a list of layers, not an MLP


def _mlp_index(kind: str, i: int, norm: bool) -> int:
    """Position of lin_i / norm_i in the reference MLP's nn.Sequential:
    each hidden layer is Linear, [LayerNorm], activation."""
    step = 3 if norm else 2
    return i * step + (1 if kind == "norm" else 0)


def flax_params_to_state_dict(params) -> Dict[str, torch.Tensor]:
    """{'params': nested flax tree of arrays} (or the inner tree) -> the
    port's state_dict; the exact inverse of
    targetdiff_tpu.utils.port.torch_state_dict_to_flax, and of
    `state_dict_to_flax_params`."""
    tree = params["params"] if "params" in params else params
    out = {}

    def walk(node, names):
        norm = any(k.startswith("norm_") for k in node)
        for key, child in node.items():
            if not isinstance(child, Mapping):
                arr = np.asarray(child)
                leaf = key
                if key == "kernel":
                    leaf, arr = "weight", arr.T
                elif key == "scale":
                    leaf = "weight"
                out[".".join(names + [leaf])] = torch.tensor(arr)
                continue
            m = _MLP_LEAF.match(key)
            if key == "Swish_0":
                seg = f"net.{_mlp_index('lin', 1, norm) - 1}"
            elif m:
                seg = f"net.{_mlp_index(m.group(1), int(m.group(2)), norm)}"
            else:
                seg = key
                for pat, rep in _SEGMENT:
                    if pat.match(key):
                        seg = pat.sub(rep, key)
                        break
            walk(child, names + [seg])

    walk(tree, [])
    return out


_PAIR = {"base_block": "block_{}", "x2h_layers": "x2h_{}", "h2x_layers": "h2x_{}",
         "v_inference": "v_inference_{}", "x_mlp": "x_mlp_{}", "out": "out_{}",
         "enc_node": "enc_node_{}"}
_SINGLE = ("ew_net", "edge_inf")  # nn.Sequential(Linear, Sigmoid) -> one flax Linear
_TIME_EMB = {"1": "time_emb_l1", "3": "time_emb_l2"}  # nn.Sequential(sin, Linear, GELU, Linear)


def state_dict_to_flax_params(state_dict) -> Dict:
    """The port's state_dict -> {'params': nested flax tree of numpy arrays};
    the inverse of `flax_params_to_state_dict`."""
    normed = {name.rsplit(".", 3)[0] if name.count(".") > 2 else ""
              for name, t in state_dict.items()
              if name.split(".")[-3:] == ["net", "1", "weight"] and t.dim() == 1}
    tree: Dict = {}
    for name, tensor in state_dict.items():
        toks = name.split(".")
        segs, i = [], 0
        while i < len(toks) - 1:
            tok = toks[i]
            if tok in _PAIR:
                segs.append(_PAIR[tok].format(toks[i + 1]))
                i += 2
            elif tok == "net" and i > 0 and toks[i - 1] in _LAYER_LISTS:
                segs.append(f"layer_{toks[i + 1]}")
                i += 2
            elif tok == "net" and toks[-1] == "beta":
                segs.append("Swish_0")
                i += 2
            elif tok == "net":
                step = 3 if ".".join(toks[:i]) in normed else 2
                idx = int(toks[i + 1])
                segs.append(f"norm_{idx // step}" if idx % step == 1 else f"lin_{idx // step}")
                i += 2
            elif tok == "time_emb":
                segs.append(_TIME_EMB[toks[i + 1]])
                i += 2
            elif tok in _SINGLE:
                segs.append(tok)
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
        node[leaf] = np.array(arr, order="C")  # keeps a 0-d array (Swish beta) 0-d
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
