"""Import a reference (PyTorch) checkpoint, ported from ``mca_tpu/tools/import_checkpoint.py``.

    python -m mca_tpu_torch.tools.import_checkpoint train_config.yaml \\
        CHECKPOINT OUT_DIR [--with-optimizer] [--export FILE.safetensors]

``train_config.yaml`` is the training config the checkpoint was trained
with.  ``CHECKPOINT`` is a ``.safetensors`` / ``.bin`` / ``.pt`` file or
an Accelerate ``save_state`` directory (the formats of the reference's
published checkpoints).  The weights load into the config's model with
``load_state_dict(strict=True)`` (the port's parameter names are the
reference's), and ``OUT_DIR`` gets the port's checkpoint layout
(:mod:`mca_tpu_torch.checkpoint`):

- by default the parameters, ``OUT_DIR/model/model.pt``, which
  ``infer`` / ``serve`` read as ``restart:``;
- with ``--with-optimizer`` (``CHECKPOINT`` an Accelerate directory
  holding ``optimizer.bin``), a full train state ``OUT_DIR/state/state.pt``
  that ``train``'s ``restart:`` continues: the AdamW moments of
  ``optimizer.bin`` (mapped by the reference's parameter order,
  :func:`mca_tpu_torch.interop.ref_param_names`; zeros for a parameter
  the state lacks), every parameter's step and the schedule at
  ``scheduler.bin``'s step (else the optimizer's), the moments at the
  config's ``moment_dtype``.  The run that restarts takes its own
  schedule's rate at that step.

``--export FILE`` also writes the imported parameters as a
reference-named safetensors file (the port's own writer,
:func:`mca_tpu_torch.checkpoint.export_safetensors`).

The tool rearranges weights and does no device work: it runs on the
CPU.  The JAX tool's ``--from-orbax DIR`` exports a JAX run's orbax
parameters; the port has no orbax checkpoints, and a port run writes its
reference-named ``model.safetensors`` itself.  Its ``--state-mode flat |
tree`` picks the JAX optimizer state's layout; the port has one layout
(torch's AdamW state dict).  Neither option exists here.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import warnings

import torch

logger = logging.getLogger(__name__)


def import_checkpoint(config, checkpoint_path: str, out_dir: str, *,
                      with_optimizer: bool = False, export: str = "") -> dict:
    """Import ``checkpoint_path`` for ``config`` into ``out_dir`` (module
    docstring); returns ``{"tensors": n, "step": step or None}``."""
    from mca_tpu_torch import checkpoint
    from mca_tpu_torch.interop import (import_optimizer_state, load_accelerate_dir,
                                       load_torch_state_dict)
    from mca_tpu_torch.parallel.mesh import SINGLE
    from mca_tpu_torch.train import build_trainer, plain

    if with_optimizer and not os.path.isdir(checkpoint_path):
        raise ValueError("--with-optimizer needs an Accelerate save_state directory "
                         "(optimizer.bin lives beside the weights)")
    sd = load_torch_state_dict(checkpoint_path)
    # the schedule's horizon is the restarting run's (load_train_state)
    model, optimizer, schedule = build_trainer(config, "cpu", num_training_steps=1000,
                                               params=sd, mesh=SINGLE)
    params = model.state_dict()
    step = None
    if with_optimizer:
        saved = load_accelerate_dir(checkpoint_path, load_model=False)
        if saved["optimizer"] is None:
            raise ValueError(f"no optimizer.bin under {checkpoint_path}")
        names = [n for n, _ in model.named_parameters()]
        moments, count = import_optimizer_state(
            saved["optimizer"], names, list(plain(config.encoder_configs)), model_sd=sd)
        step = saved["scheduler_step"] if saved["scheduler_step"] is not None else count
        dtype = getattr(optimizer, "moment_dtype", None)
        for name, p in model.named_parameters():
            mu, nu = moments.get(name, (torch.zeros_like(p), torch.zeros_like(p)))
            if tuple(mu.shape) != tuple(p.shape):
                raise ValueError(f"moment shape mismatch for {name}: {tuple(mu.shape)} "
                                 f"against {tuple(p.shape)}")
            optimizer.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": mu.to(dtype or p.dtype).clone(),
                "exp_avg_sq": nu.to(dtype or p.dtype).clone(),
            }
        with warnings.catch_warnings():  # a schedule stepped without an optimizer step
            warnings.simplefilter("ignore", UserWarning)
            for _ in range(step):
                schedule.step()
        checkpoint.Checkpointer().save_state(
            {"model": params, "optimizer": optimizer.state_dict(),
             "schedule": schedule.state_dict(), "step": int(step), "epoch": 0}, out_dir)
        logger.info("optimizer moments and step %d imported", step)
    else:
        checkpoint.save_params(params, out_dir)
    if export:
        checkpoint.export_safetensors(params, export)
        logger.info("exported %d tensors -> %s", len(params), export)
    logger.info("imported %d tensors -> %s", len(sd), out_dir)
    return {"tensors": len(sd), "step": step}


def main(argv=None) -> int:
    from mca_tpu_torch.config import training_config

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="the train config YAML the checkpoint was trained with")
    ap.add_argument("checkpoint", help="a torch checkpoint file or an Accelerate directory")
    ap.add_argument("out_dir", help="the port checkpoint directory to write")
    ap.add_argument("--export", metavar="FILE", default="",
                    help="also write a reference-named .safetensors of the parameters")
    ap.add_argument("--with-optimizer", action="store_true",
                    help="also import the AdamW moments and the scheduler step from an "
                         "Accelerate save_state directory into a full train state")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(level=logging.INFO)
    # the modalities' order is the file's (the reference's parameter order)
    config = training_config(args.config, make_output_dir=False)
    import_checkpoint(config, args.checkpoint, args.out_dir,
                      with_optimizer=args.with_optimizer, export=args.export)
    return 0


if __name__ == "__main__":
    sys.exit(main())
