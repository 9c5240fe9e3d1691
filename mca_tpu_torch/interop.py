"""Weight carry from the JAX package into the port.

:func:`state_dict_from_jax_params` maps a JAX/flax parameter tree (numpy
leaves, ``{'params': {...}}`` or the inner dict) onto the torch
reference's state_dict names, which are exactly the port's module names,
so ``model.load_state_dict(sd, strict=True)`` is the bridge.  The key
map is the port's own copy of ``mca_tpu/interop.py``'s
``build_key_map`` / ``export_state_dict``: torch ``nn.Linear`` stores
``[out, in]`` kernels and flax ``[in, out]``, so the ``linear`` kind
transposes; flax LayerNorm ``scale`` / ``bias`` map to ``weight`` /
``bias``, the transformer's bias-less norm ``scale`` to ``gamma``.  A
tree after ``mca_tpu.ops.quant.quantize_params`` carries its int8
``{kernel_q, scale}`` projections to the int8 model's ``weight_q`` /
``scale`` buffers, untransposed.
:func:`probe_head_state_from_jax` carries a probe head the same way.

Reference checkpoints (``tools/import_checkpoint``): :func:`load_torch_state_dict`
reads a ``.safetensors`` / ``.bin`` / ``.pt`` file or an Accelerate
``save_state`` directory, :func:`load_accelerate_dir` also its
``optimizer.bin`` and ``scheduler.bin``, and :func:`import_optimizer_state`
maps the torch AdamW state (keyed by the parameter's index in the
reference's ``model.parameters()`` order, :func:`ref_param_names`) onto
the port's names.  The port's copies of ``mca_tpu/interop.py``'s: the
port's names and layouts are the reference's, so nothing is transposed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def _map_pool_projections(out: KeyMap, key: str, tree: Dict[str, Any]) -> None:
    """A mean pool's ``proj_{i}`` Dense layers -> ``attn_pool.proj.{i}``
    (the reference registers its mean pool as ``self.attn_pool``).  No
    family that either package builds reaches this: MCA's ``mean_pool``
    and EAO pool without projections.  It carries the JAX package's map
    (``mca_tpu.interop``) for a tree from a model that does project."""
    for sub in sorted(tree):
        if sub.startswith("proj_"):
            i = int(sub.split("_")[1])
            out.append(((key, sub, "kernel"), f"attn_pool.proj.{i}.weight", "linear"))
            if "bias" in tree[sub]:
                out.append(((key, sub, "bias"), f"attn_pool.proj.{i}.bias", "direct"))


def _map_projection(
    out: KeyMap, tree: Dict[str, Any], base: Tuple[str, ...], prefix: str
) -> None:
    """A block projection: ``kernel`` -> ``<prefix>.weight``, transposed;
    after ``mca_tpu.ops.quant.quantize_params``, ``{kernel_q, scale}`` ->
    ``<prefix>.weight_q`` (int8, ``[in, out]`` as it stands) and
    ``<prefix>.scale``."""
    if "kernel_q" in tree:
        out.append((base + ("kernel_q",), f"{prefix}.weight_q", "direct"))
        out.append((base + ("scale",), f"{prefix}.scale", "direct"))
    else:
        out.append((base + ("kernel",), f"{prefix}.weight", "linear"))


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
                _map_projection(
                    out, tree["attn"][proj], (key, "attn", proj),
                    f"layers.{i}.attn.{proj}",
                )
            if "router" in tree.get("ff", {}):
                # the MoE feed-forward under the JAX package's extension
                # names, un-transposed ([dim, E], [E, dim, 2 * inner],
                # [E, inner, dim])
                for leaf, name in (("router", "router.weight"),
                                   ("w_in", "experts.w_in"), ("w_out", "experts.w_out")):
                    out.append(((key, "ff", leaf), f"layers.{i}.ff.{name}", "direct"))
            else:
                for leaf, index in (("w_in", 0), ("w_out", 2)):
                    _map_projection(
                        out, tree["ff"][leaf], (key, "ff", leaf),
                        f"layers.{i}.ff.feedforward.{index}",
                    )
            out.append(
                ((key, "norm", "LayerNorm_0", "scale"), f"layers.{i}.norm.gamma", "direct")
            )
        elif key == "final_norm":
            out.append(((key, "LayerNorm_0", "scale"), "norm.gamma", "direct"))
        elif key in ("fusion_tokens", "return_tokens"):
            out.append(((key,), key, "direct"))
        elif key == "attn_pool" and "to_q" in tree:
            for proj in ("to_q", "to_kv", "to_out"):
                out.append(
                    ((key, proj, "kernel"), f"attn_pool.{proj}.weight", "linear")
                )
        elif key in ("attn_pool", "pool"):
            # a MeanTokenProjectionPool with its projections; MCA's
            # mean_pool and EAO build theirs without (``projection=False``),
            # so their trees hold no pool entry at all
            _map_pool_projections(out, key, tree)
        elif key == "loss":
            if "logit_scale" in tree:
                out.append(
                    ((key, "logit_scale"), "loss.loss_fn.logit_scale", "direct")
                )
            # separate_modal_loss_fns: one temperature per pair and combo
            for leaf in sorted(k for k in tree if k.startswith("logit_scale_")):
                out.append(((key, leaf), f"loss.{leaf}", "direct"))
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
        v = np.asarray(_get(p, path))
        if v.dtype != np.int8:  # int8 kernels stay int8
            v = v.astype(np.float32)
        sd[key] = torch.from_numpy(np.array(v.T if kind == "linear" else v))
    return sd


def probe_head_state_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A ``mca_tpu.probe.ProbeHead`` parameter tree (numpy leaves) -> the
    state dict of ``mca_tpu_torch.probe.ProbeHead``: ``Dense_{i}`` ->
    ``dense_{i}``, kernels transposed to ``[out, in]``."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name in sorted(p):
        i = int(name.split("_")[1])
        kernel = np.asarray(p[name]["kernel"], dtype=np.float32)
        sd[f"dense_{i}.weight"] = torch.from_numpy(np.array(kernel.T))
        sd[f"dense_{i}.bias"] = torch.from_numpy(
            np.array(p[name]["bias"], dtype=np.float32)
        )
    return sd


# ---------------------------------------------------------------------------
# reference checkpoints: weights, AdamW state, schedule step
# ---------------------------------------------------------------------------

_STATE_FILES = ("model.safetensors", "pytorch_model.bin", "pytorch_model.pt",
                "model.bin", "model.pt")
_NOT_MODEL = ("optimizer", "scheduler", "random_state", "scaler", "sampler")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict from a file or an Accelerate ``save_state`` /
    ``save_model`` directory, on the CPU: ``.safetensors`` through
    :func:`mca_tpu_torch.checkpoint.read_safetensors` (no ``safetensors``
    package), ``.bin`` / ``.pt`` through ``torch.load``; a ``state_dict``
    entry is unwrapped and a DDP ``module.`` prefix dropped."""
    from mca_tpu_torch.checkpoint import read_safetensors

    if os.path.isdir(path):
        for name in _STATE_FILES:
            if os.path.exists(os.path.join(path, name)):
                path = os.path.join(path, name)
                break
        else:
            # never the optimizer / scheduler / rng files beside the weights
            found = sorted(f for f in os.listdir(path)
                           if f.endswith((".safetensors", ".bin", ".pt"))
                           and not f.startswith(_NOT_MODEL))
            if not found:
                raise FileNotFoundError(f"no torch checkpoint file under {path}")
            path = os.path.join(path, found[0])
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def load_accelerate_dir(path: str, load_model: bool = True) -> Dict[str, Any]:
    """An ``accelerator.save_state`` directory: ``{"model": state dict or
    None, "optimizer": the AdamW state dict or None, "scheduler_step": the
    scheduler's ``last_epoch`` (completed optimizer steps) or None}``."""
    out: Dict[str, Any] = {"model": load_torch_state_dict(path) if load_model else None,
                           "optimizer": None, "scheduler_step": None}
    opt_path = os.path.join(path, "optimizer.bin")
    if os.path.exists(opt_path):
        out["optimizer"] = torch.load(opt_path, map_location="cpu", weights_only=True)
    sched_path = os.path.join(path, "scheduler.bin")
    if os.path.exists(sched_path):
        sched = torch.load(sched_path, map_location="cpu", weights_only=True)
        if isinstance(sched, dict) and "last_epoch" in sched:
            out["scheduler_step"] = int(sched["last_epoch"])
    return out


# each encoder's parameters in the reference's registration order; the
# four encoder kinds hold disjoint sets
_ENCODER_ORDER = (
    # TabularEncoder / SparseTabularEncoder, SequenceEncoder
    "token_encoder.embedding.weight",
    *(f"value_encoder.{m}.{p}" for m in ("linear1", "linear2", "norm")
      for p in ("weight", "bias")),
    # PatchEncoder
    *(f"batch_to_tokens.{i}.{p}" for i in (1, 2, 3) for p in ("weight", "bias")),
    "embedding.weight",
    # EmbeddedSequenceEncoder
    *(f"token_encoder.{i}.{p}" for i in (0, 1, 2) for p in ("weight", "bias")),
)
_LAYER_ORDER = ("attn.to_q.weight", "attn.to_kv.weight", "attn.to_out.weight",
                "ff.feedforward.0.weight", "ff.feedforward.2.weight", "norm.gamma")


def ref_param_names(names: Sequence[str], modalities: Sequence[str]) -> List[str]:
    """The port's parameter ``names`` (state-dict names, the reference's)
    in the reference's ``model.parameters()`` order: the model's own
    tokens, then the encoders in ``modalities`` order (the checkpoint's
    ``encoder_configs`` order), the blocks, the final norm, the pool and
    the loss's temperature (``mca_tpu.interop.ref_param_names``).  A
    parameter the reference has no counterpart for (a MoE block, a
    per-pair temperature) raises."""
    present = set(names)
    out = [n for n in ("fusion_tokens", "return_tokens") if n in present]
    for m in modalities:
        out += [f"encoders.{m}.{n}" for n in _ENCODER_ORDER if f"encoders.{m}.{n}" in present]
    depth = 1 + max((int(n.split(".")[1]) for n in names if n.startswith("layers.")),
                    default=-1)
    for i in range(depth):
        out += [f"layers.{i}.{n}" for n in _LAYER_ORDER]
    if "norm.gamma" in present:
        out.append("norm.gamma")
    out += [f"attn_pool.{p}.weight" for p in ("to_q", "to_kv", "to_out")
            if f"attn_pool.{p}.weight" in present]
    proj = sorted({int(n.split(".")[2]) for n in names if n.startswith("attn_pool.proj.")})
    for i in proj:
        out += [n for n in (f"attn_pool.proj.{i}.weight", f"attn_pool.proj.{i}.bias")
                if n in present]
    if "loss.loss_fn.logit_scale" in present:
        out.append("loss.loss_fn.logit_scale")
    unmapped = sorted(present - set(out))
    if unmapped or len(set(out)) != len(out) or not present >= set(out):
        raise ValueError("parameters with no reference counterpart (a torch optimizer "
                         f"state cannot be mapped onto them): {unmapped[:8]}")
    return out


def import_optimizer_state(
    opt_sd: Dict[str, Any],
    names: Sequence[str],
    modalities: Sequence[str],
    model_sd: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Tuple[torch.Tensor, torch.Tensor]], int]:
    """A torch AdamW ``state_dict()`` onto the port's parameter ``names``:
    ``({name: (exp_avg, exp_avg_sq)} in fp32, the largest per-parameter
    step)``.  A parameter the state holds no entry for (it never had a
    gradient) is left out: the caller gives it zero moments, as torch's
    AdamW would create them.  ``model_sd`` (the weights saved beside the
    optimizer) tells of the reference's zero-size ``fusion_tokens`` under
    ``no_fusion``, which takes an index but has no counterpart here."""
    order = ref_param_names(names, modalities)
    if model_sd is not None and "fusion_tokens" in model_sd and "fusion_tokens" not in names:
        order = ["fusion_tokens"] + order
    idxs = [i for g in opt_sd.get("param_groups", []) for i in g.get("params", [])]
    if idxs and len(idxs) != len(order):
        raise ValueError(f"optimizer state covers {len(idxs)} parameters but the model "
                         f"maps {len(order)}: wrong config or modality order for this "
                         "checkpoint?")
    state = opt_sd.get("state", {})
    moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    count = 0
    for i, name in enumerate(order):
        st = state.get(i, state.get(str(i)))
        if st is None:
            continue
        if "step" in st:
            count = max(count, int(torch.as_tensor(st["step"]).item()))
        if name not in names:
            continue  # the zero-size fusion_tokens placeholder
        moments[name] = tuple(torch.as_tensor(st[k]).float() for k in ("exp_avg", "exp_avg_sq"))
    return moments, count
