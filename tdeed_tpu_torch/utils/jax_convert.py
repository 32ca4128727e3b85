"""JAX {params, batch_stats} trees -> port state_dict.

The inverse of ``convert_reference_state_dict``
(tools/import_reference_checkpoint.py:187), which maps a reference T-DEED
state_dict — and therefore a port state_dict, which uses the same keys —
to the JAX package's trees. With it the JAX package's weights load into
the port with ``load_state_dict(strict=True)``, so tests run the same
function on both sides. Layout transforms are numpy only; leaves come back
as fp32 torch tensors (BN counters as int64 zeros).

Layouts (flax -> torch):
  conv kernel (kh, kw, in/g, out)      -> (out, in/g, kh, kw)
  conv3d kernel (kt, kh, kw, in/g, out) -> (out, in/g, kt, kh, kw)
  conv1d kernel (k, in/g, out)          -> (out, in/g, k)
  dense kernel (in, out)                -> (out, in), or (out, in, 1) for
                                           the reference's 1x1 Conv1d MLP
  SGP LayerNorm scale/bias (C,)         -> (1, C, 1)
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK_RE = re.compile(r"^s(\d+)_b(\d+)$")
_SGP_RE = re.compile(r"^(sgp|mixer)_(\d+)$")
_DW_NAMES = {
    "psi", "fc", "convw", "convkw", "global_fc",
    "psi1", "psi2", "convw1", "convkw1", "convw2", "convkw2",
    "fc1", "fc2", "global_fc1", "global_fc2",
}


def _t(x, transpose=None, shape=None) -> torch.Tensor:
    a = np.asarray(x, dtype=np.float32)
    if transpose is not None:
        a = np.transpose(a, transpose)
    if shape is not None:
        a = a.reshape(shape)
    return torch.from_numpy(a.copy())  # owned, writable, contiguous


def _conv_bn(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.conv.weight"] = _t(p["conv"]["kernel"], (3, 2, 0, 1))
    _bn(sd, f"{prefix}.bn", p["bn"], s["bn"])


def _bn(sd: Dict, prefix: str, p: Mapping, s: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(s["mean"])
    sd[f"{prefix}.running_var"] = _t(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _block(sd: Dict, base: str, p: Mapping, s: Mapping) -> None:
    shifted = "gs" in p
    for name, node in p.items():
        if name in ("conv1", "conv2", "conv3", "downsample"):
            prefix = f"{base}.conv1.net" if name == "conv1" and shifted else f"{base}.{name}"
            _conv_bn(sd, prefix, node, s[name])
        elif name == "se":
            for fc in ("fc1", "fc2"):
                sd[f"{base}.se.{fc}.weight"] = _t(node[fc]["kernel"], (3, 2, 0, 1))
                sd[f"{base}.se.{fc}.bias"] = _t(node[fc]["bias"])
        elif name == "gs":
            g, gs = node["gs"], s["gs"]["gs"]
            # GSF nests its gate in a bare-conv module (gate_conv/conv/*),
            # GSM keeps it at gate_conv/* (tdeed_tpu/models/shift.py:54-66)
            gate = g["gate_conv"].get("conv", g["gate_conv"])
            sd[f"{base}.conv1.gs.conv3D.weight"] = _t(gate["kernel"], (4, 3, 0, 1, 2))
            sd[f"{base}.conv1.gs.conv3D.bias"] = _t(gate["bias"])
            _bn(sd, f"{base}.conv1.gs.bn", g["bn"], gs["bn"])
            for cc in ("channel_conv1", "channel_conv2"):
                if cc in g:  # GSF's fusion convs; GSM has none
                    conv = g[cc]["conv"]
                    sd[f"{base}.conv1.gs.{cc}.weight"] = _t(conv["kernel"], (3, 2, 0, 1))
                    sd[f"{base}.conv1.gs.{cc}.bias"] = _t(conv["bias"])
        else:
            raise KeyError(f"unrecognized backbone entry {base}/{name}")


def _sgp(sd: Dict, prefix: str, p: Mapping) -> None:
    for name, node in p.items():
        if name in ("ln", "ln1", "ln2"):
            sd[f"{prefix}.{name}.weight"] = _t(node["scale"], shape=(1, -1, 1))
            sd[f"{prefix}.{name}.bias"] = _t(node["bias"], shape=(1, -1, 1))
        elif name == "ffn":
            sd[f"{prefix}.gn.weight"] = _t(node["gn"]["scale"])
            sd[f"{prefix}.gn.bias"] = _t(node["gn"]["bias"])
            for fc, idx in (("mlp_fc1", 0), ("mlp_fc2", 2)):
                dense = node[fc]["dense"]
                sd[f"{prefix}.mlp.{idx}.weight"] = _t(dense["kernel"], (1, 0))[..., None]
                sd[f"{prefix}.mlp.{idx}.bias"] = _t(dense["bias"])
        elif name == "concat_fc":
            sd[f"{prefix}.concat_fc.weight"] = _t(node["kernel"], (2, 1, 0))
            sd[f"{prefix}.concat_fc.bias"] = _t(node["bias"])
        elif name in _DW_NAMES:
            conv = node["Conv_0"]
            sd[f"{prefix}.{name}.weight"] = _t(conv["kernel"], (2, 1, 0))
            sd[f"{prefix}.{name}.bias"] = _t(conv["bias"])
        else:
            raise KeyError(f"unrecognized SGP entry {prefix}/{name}")


def params_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TDEED {params, batch_stats} -> port TDEED state_dict. Unknown
    entries raise KeyError."""
    sd: Dict[str, torch.Tensor] = {}
    for top, node in params.items():
        if top == "temp_enc":
            sd["temp_enc"] = _t(node)
        elif top == "features":
            stats = batch_stats["features"]
            for blk, p in node.items():
                if blk == "stem":
                    _conv_bn(sd, "_features.stem", p, stats["stem"])
                    continue
                m = _BLOCK_RE.match(blk)
                if m is None:
                    raise KeyError(f"unrecognized backbone block {blk}")
                _block(sd, f"_features.s{m.group(1)}.b{m.group(2)}", p, stats[blk])
        elif top == "temp_fine":
            for name, p in node.items():
                m = _SGP_RE.match(name)
                if m is None:
                    raise KeyError(f"unrecognized temp_fine entry {name}")
                group = "_sgp" if m.group(1) == "sgp" else "_sgpMixer"
                _sgp(sd, f"_temp_fine.{group}.{m.group(2)}", p)
        elif top in ("pred_fine", "pred_displ"):
            # FCLayers, or the FC2 double head's fc1 and fc2 (ref keys
            # _pred_fine._fc{1,2}._fc_out.*)
            heads = {"": node} if "fc_out" in node else {
                f"._{name}": node[name] for name in ("fc1", "fc2")}
            for sub, head in heads.items():
                dense = head["fc_out"]["dense"]
                sd[f"_{top}{sub}._fc_out.weight"] = _t(dense["kernel"], (1, 0))
                sd[f"_{top}{sub}._fc_out.bias"] = _t(dense["bias"])
        else:
            raise KeyError(f"unrecognized top-level entry {top}")
    return sd
