"""AOT export of the serving forward, ported from ``mca_tpu/tools/export_aot.py``.

``torch.export`` traces the packed embedding forward (``[E, B, D]``
embeddings, ``[M, B]`` presence masks) at a fixed batch, with the
weights, the prepared feed-forward weights and the flash schedules held
in the program, and ``torch.export.save`` writes it.  The flash forward
(K1) and the fused feed-forward (K5) stay calls of their operators
(``mca_tpu_torch::flash_fwd``, ``mca_tpu_torch::geglu_ff``), so a loaded
program launches the same kernels, counted in the same ``launches``.

    python -m mca_tpu_torch.tools.export_aot cfg.yaml --out model.aot \\
        --batch 8 [--quantize int8] [--restart DIR] [--device cpu]
    python -m mca_tpu_torch.serve --aot model.aot

    from mca_tpu_torch.tools.export_aot import load_aot
    fn, emb_keys, mask_keys = load_aot("model.aot")
    emb, msk = fn(batch)  # a collated batch of exactly the exported size

The file is the JAX package's layout with the port's own magic line: the
magic, an 8-byte little-endian header length, a JSON header
(``emb_keys``, ``mask_keys``, ``modality_config``, ``batch``, and the
``device`` type and ``quantize`` mode it was exported with), then
``torch.export.save``'s bytes.  Each package's loader refuses the
other's artifact.  A program runs on the device type it was exported on.

Loading imports this module, the two modules that register the
operators and nothing of the config, model or encoder code.
"""

from __future__ import annotations

import copy
import io
import json
import logging
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from mca_tpu_torch.serve import pack_outputs

logger = logging.getLogger(__name__)

MAGIC = b"MCATORCHAOT1\n"
JAX_MAGIC = b"MCAAOT1\n"  # mca_tpu.tools.export_aot's


class PackedForward(torch.nn.Module):
    """The serving forward as one traceable module: a collated batch ->
    ``(emb [E, B, D], msk [M, B])``."""

    def __init__(self, model: torch.nn.Module, emb_keys, mask_keys):
        super().__init__()
        self.model = model
        self.emb_keys = tuple(emb_keys)
        self.mask_keys = tuple(mask_keys)

    def forward(self, batch):
        return pack_outputs(
            self.model(batch, no_loss=True), self.emb_keys, self.mask_keys
        )


def _prepared_only(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose fused feed-forwards keep only their
    prepared buffers: a trace reads those, and the float weights left
    beside them would double the feed-forward's bytes in the program."""
    from mca_tpu_torch.masks import MaskSet
    from mca_tpu_torch.models.layers import FeedForward

    # the static masks stay the same objects: the flash schedules are
    # cached by the mask's identity
    memo = {id(v): v for m in model.modules() for v in vars(m).values()
            if isinstance(v, (np.ndarray, MaskSet))}
    model = copy.deepcopy(model, memo)
    for m in model.modules():
        if isinstance(m, FeedForward) and m.fused:
            m.feedforward = torch.nn.ModuleList()
    return model


def export_packed_forward(
    config,
    state_dict: Optional[Mapping[str, Any]],
    batch: Dict[str, Dict[str, torch.Tensor]],
    model: Optional[torch.nn.Module] = None,
    device: str = "cuda",
) -> Tuple[bytes, Tuple[str, ...], Tuple[str, ...]]:
    """``torch.export.save`` bytes of the packed forward at ``batch``'s
    shapes, with ``(emb_keys, mask_keys)``.

    ``model`` (already holding its weights, float or int8) skips the
    build; otherwise the model is built from ``config`` and loaded from
    ``state_dict`` (an int8 one, with ``weight_q`` entries, builds the
    int8 model).  One eager forward on ``batch`` runs first: it makes the
    feed-forward's prepared weights and uploads the flash schedules that
    the trace holds as constants.
    """
    if model is None:
        from mca_tpu_torch.config import get_model_config
        from mca_tpu_torch.models import build_model

        quant = "int8" if any(k.endswith(".weight_q") for k in state_dict) else "none"
        model = build_model(dict(get_model_config(config), quant=quant), fused_ff=True)
        model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port exports its GPU forward on the GPU; "
            "pass device='cpu' for a CPU program of the plain versions"
        )
    model = model.to(device).eval()
    batch = {m: {k: v.to(device) for k, v in f.items()} for m, f in batch.items()}
    with torch.no_grad():
        out = model(batch, no_loss=True)
        mask_keys = tuple(sorted(out["modality_sample_mask"]))
        emb_keys = tuple(sorted(k for k in out if k != "modality_sample_mask"))
        packed = PackedForward(_prepared_only(model), emb_keys, mask_keys)
        program = torch.export.export(packed, (batch,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue(), emb_keys, mask_keys


def save_aot(
    path: str,
    blob: bytes,
    emb_keys,
    mask_keys,
    modality_config=None,
    batch: int = 0,
    device: str = "cuda",
    quantize: str = "none",
) -> None:
    """MAGIC + header length + JSON header + the program's bytes.
    ``modality_config`` and ``batch`` let ``serve --aot`` rebuild the
    collator and the request padding from the header alone."""
    header = json.dumps(
        {
            "emb_keys": list(emb_keys),
            "mask_keys": list(mask_keys),
            "modality_config": modality_config,
            "batch": int(batch),
            "device": torch.device(device).type,
            "quantize": quantize,
        }
    ).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob)


def _read(f) -> Dict[str, Any]:
    head = f.read(len(MAGIC))
    if head != MAGIC:
        if head.startswith(JAX_MAGIC):
            raise ValueError(
                "a JAX package artifact (mca_tpu.tools.export_aot, StableHLO): "
                "load it with mca_tpu; export for the port with "
                "mca_tpu_torch.tools.export_aot"
            )
        raise ValueError("not an mca_tpu_torch AOT artifact")
    n = int.from_bytes(f.read(8), "little")
    return json.loads(f.read(n))


def read_aot_header(path: str) -> Dict[str, Any]:
    """The artifact's JSON header; raises ``ValueError`` for anything
    that is not the port's artifact."""
    with open(path, "rb") as f:
        return _read(f)


def load_aot_full(
    path: str, device: Optional[str] = None
) -> Tuple[Callable, Dict[str, Any]]:
    """``(callable(batch) -> (emb, msk), header)``.  ``device``, where
    given, must be of the type the program was exported on."""
    # the operators the program calls must be registered before it loads
    import mca_tpu_torch.ops.flash_attention  # noqa: F401
    import mca_tpu_torch.ops.fused_ff  # noqa: F401

    with open(path, "rb") as f:
        header = _read(f)
        exported_on = header.get("device", "cuda")
        if device is not None and torch.device(device).type != exported_on:
            raise ValueError(
                f"{path} was exported on {exported_on}, not "
                f"{torch.device(device).type}: export it again there"
            )
        program = torch.export.load(io.BytesIO(f.read()))
    module = program.module()
    return module, header


def load_aot(path: str, device: Optional[str] = None):
    """``(callable(batch) -> (emb, msk), emb_keys, mask_keys)``."""
    fn, header = load_aot_full(path, device)
    return fn, tuple(header["emb_keys"]), tuple(header["mask_keys"])


def main(argv=None) -> None:
    import argparse
    import os
    import sys

    from mca_tpu_torch.config import training_config
    from mca_tpu_torch.serve import QUANT_MODES, EmbeddingService

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config")
    p.add_argument("--restart", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument(
        "--quantize", choices=QUANT_MODES, default="none",
        help="hold the block projections as int8 in the program (ops.quant)",
    )
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--allow-random-weights", action="store_true",
        help="export random weights drawn from --seed (demo only)",
    )
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    config = training_config(args.config)
    restart = args.restart or (config.restart or None)
    if not (restart or args.allow_random_weights):
        raise SystemExit(
            "no checkpoint: pass --restart <dir>, or --allow-random-weights"
        )
    svc = EmbeddingService(
        config,
        restart=restart,
        max_batch=args.batch,
        warmup=False,
        quantize=args.quantize,
        device=args.device,
        seed=args.seed,
    )
    batch = svc._pad([svc._template] * args.batch)
    blob, emb_keys, mask_keys = export_packed_forward(
        config, None, batch, model=svc.model, device=args.device
    )
    save_aot(
        args.out, blob, emb_keys, mask_keys,
        modality_config=(
            config.modality_config.to_plain()
            if hasattr(config.modality_config, "to_plain")
            else dict(config.modality_config)
        ),
        batch=args.batch, device=args.device, quantize=args.quantize,
    )
    logger.info(
        "exported %s (%d bytes, batch %d, %s, quantize %s, keys %s)",
        args.out, os.path.getsize(args.out), args.batch, args.device,
        args.quantize, ",".join(emb_keys),
    )
    # the round trip: the program loads and gives finite embeddings
    fn, _, _ = load_aot(args.out, args.device)
    with torch.inference_mode():
        emb, _ = fn(batch)
    if not bool(torch.isfinite(emb).all()):
        raise RuntimeError(f"{args.out}: the loaded program gives non-finite embeddings")


if __name__ == "__main__":
    main()
