"""Weight carry from the JAX package into the port.

:func:`state_dict_from_jax_params` maps a JAX/flax parameter tree (numpy
leaves, ``{'params': {...}}`` or the inner dict) onto the torch
reference's state_dict names, which are exactly the port's module names,
so ``model.load_state_dict(sd, strict=True)`` is the bridge.  The key
map is the port's own copy of ``mca_tpu/interop.py``'s
``build_key_map`` / ``export_state_dict``: torch ``nn.Linear`` stores
``[out, in]`` kernels and flax ``[in, out]``, so the ``linear`` kind
transposes; flax LayerNorm ``scale`` / ``bias`` map to ``weight`` /
``bias``, the transformer's bias-less norm ``scale`` to ``gamma``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (flax path, reference key, kind); kind "linear" transposes
KeyMap = List[Tuple[Tuple[str, ...], str, str]]


def _map_value_encoder(out: KeyMap, base: Tuple[str, ...], prefix: str) -> None:
    for lin in ("linear1", "linear2"):
        out.append((base + (lin, "kernel"), f"{prefix}.{lin}.weight", "linear"))
        out.append((base + (lin, "bias"), f"{prefix}.{lin}.bias", "direct"))
    out.append((base + ("norm", "scale"), f"{prefix}.norm.weight", "direct"))
    out.append((base + ("norm", "bias"), f"{prefix}.norm.bias", "direct"))


def _map_norm_proj_norm(
    out: KeyMap, base: Tuple[str, ...], prefix: str, start: int = 0
) -> None:
    i, j, k = start, start + 1, start + 2
    out.append((base + ("pre_norm", "scale"), f"{prefix}.{i}.weight", "direct"))
    out.append((base + ("pre_norm", "bias"), f"{prefix}.{i}.bias", "direct"))
    out.append((base + ("proj", "kernel"), f"{prefix}.{j}.weight", "linear"))
    out.append((base + ("proj", "bias"), f"{prefix}.{j}.bias", "direct"))
    out.append((base + ("post_norm", "scale"), f"{prefix}.{k}.weight", "direct"))
    out.append((base + ("post_norm", "bias"), f"{prefix}.{k}.bias", "direct"))


def _map_encoder(out: KeyMap, name: str, tree: Dict[str, Any]) -> None:
    base = (name,)
    prefix = f"encoders.{name}"
    if "value_encoder" in tree:  # TabularEncoder / SparseTabularEncoder
        out.append(
            (
                base + ("token_encoder", "embedding"),
                f"{prefix}.token_encoder.embedding.weight",
                "direct",
            )
        )
        _map_value_encoder(out, base + ("value_encoder",), f"{prefix}.value_encoder")
    elif "token_encoder" in tree:  # SequenceEncoder (PE is param-less)
        out.append(
            (
                base + ("token_encoder", "embedding"),
                f"{prefix}.token_encoder.embedding.weight",
                "direct",
            )
        )
    elif "pos_embedding" in tree:  # PatchEncoder
        _map_norm_proj_norm(out, base, f"{prefix}.batch_to_tokens", start=1)
        out.append(
            (base + ("pos_embedding",), f"{prefix}.embedding.weight", "direct")
        )
    elif "proj" in tree:  # EmbeddedSequenceEncoder
        _map_norm_proj_norm(out, base, f"{prefix}.token_encoder")
    else:
        raise ValueError(
            f"unrecognised encoder param structure for modality "
            f"{name!r}: {sorted(tree)}"
        )


def build_key_map(params: Dict[str, Any]) -> KeyMap:
    """(flax path, reference state_dict key, kind) triplets generated
    from a flax parameter tree."""
    p = params.get("params", params)
    out: KeyMap = []
    for key in sorted(p):
        tree = p[key]
        if key.startswith("layer_"):
            i = int(key.split("_")[1])
            for proj in ("to_q", "to_kv", "to_out"):
                out.append(
                    (
                        (key, "attn", proj, "kernel"),
                        f"layers.{i}.attn.{proj}.weight",
                        "linear",
                    )
                )
            if "router" in tree.get("ff", {}):
                raise ValueError(
                    f"{key}: MoE feed-forward layers are not ported yet"
                )
            out.append(
                ((key, "ff", "w_in", "kernel"), f"layers.{i}.ff.feedforward.0.weight", "linear")
            )
            out.append(
                ((key, "ff", "w_out", "kernel"), f"layers.{i}.ff.feedforward.2.weight", "linear")
            )
            out.append(
                ((key, "norm", "LayerNorm_0", "scale"), f"layers.{i}.norm.gamma", "direct")
            )
        elif key == "final_norm":
            out.append(((key, "LayerNorm_0", "scale"), "norm.gamma", "direct"))
        elif key in ("fusion_tokens", "return_tokens"):
            out.append(((key,), key, "direct"))
        elif key == "attn_pool":
            for proj in ("to_q", "to_kv", "to_out"):
                out.append(
                    ((key, proj, "kernel"), f"attn_pool.{proj}.weight", "linear")
                )
        elif key == "loss":
            if "logit_scale" in tree:
                out.append(
                    ((key, "logit_scale"), "loss.loss_fn.logit_scale", "direct")
                )
        elif key == "pool":
            raise ValueError("mean pooling (MeanTokenProjectionPool) is not ported yet")
        else:  # a modality encoder
            _map_encoder(out, key, tree)
    return out


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy leaves) -> the port's state dict."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for path, key, kind in build_key_map({"params": p}):
        v = np.asarray(_get(p, path), dtype=np.float32)
        sd[key] = torch.from_numpy(np.array(v.T if kind == "linear" else v))
    return sd
