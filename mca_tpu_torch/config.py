"""Config system for the PyTorch port: the same YAML surface as ``mca_tpu``.

A copy of ``mca_tpu/config.py``'s ``Config`` attribute-dict, the train
defaults, the YAML loaders and ``get_model_config``, so the port reads
the repo's configs (and the reference corpus) unchanged without
importing the JAX package.

One deliberate difference: loading a config creates no output
directory.  The serving entry point only reads a config; the JAX
loader's timestamped ``training_output_*`` directory belongs to
training, which comes with a later slice.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


class Config(dict):
    """dict with attribute access, recursive over nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls({k: cls._wrap(v) for k, v in d.items()})

    def merge(self, other: Dict[str, Any]) -> "Config":
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], dict)
                and isinstance(v, dict)
            ):
                Config.merge(self[k], v)
            else:
                self[k] = Config._wrap(v)
        return self

    def to_plain(self) -> Dict[str, Any]:
        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def get_cfg_defaults_train() -> Config:
    """Training defaults (the same keys and values as ``mca_tpu``)."""
    return Config.from_dict(
        {
            # Structure configs
            "encoder_configs": {},
            "modality_config": {},
            # Training and dataset configuration
            "restart": "",
            "wandb": False,
            "wandb_name": "No Name",
            "wandb_account_name": "",
            "wandb_restart": "",
            "wandb_job_name": "",
            "epochs": 3,
            "start_epoch": 0,
            "batch_size": 32,
            "n_step_checkpoint": 0,
            "num_warmup_steps": 3000,
            "lr_scheduler_type": "cosine",
            "lr": 1e-4,
            "output_dir": "",
            "label_col": "Labels",
            "dataset": "",
            "split": 0.1,
            "ds_frac": 1.0,
            "ds_seed": 42,
            "clip": 0.0,
            "predrop": False,
            # Model configuration
            "hidden_size": 512,
            "layers": 10,
            "heads": 8,
            "dim_head": 64,
            "ff_mult": 4,
            "num_fusion_tokens": 256,
            "seed": 42,
            "mean_pool": False,
            "dropout": 0.1,
            "zorro": False,
            "eao": False,
            "run_eval_loop": True,
            "bimodal_contrastive": True,
            "non_fusion_fcl": True,
            "fcl": True,
            "no_fusion": False,
            "fcl_root": [1, 2, 3, 4],
            "fusion_combos": [4, 3, 2],
            "return_logits": True,
            # --- extensions of the JAX package, kept so configs parse ---
            "precision": "bf16",         # compute dtype: "bf16" | "fp32"
            "attention_impl": "auto",    # dense | pallas | auto
            "mesh_data": 0,
            "mesh_model": 1,
            "mesh_pipe": 1,
            "pipeline_microbatches": 0,
            "seq_shard": False,
            "fsdp": False,
            "grad_accum": 1,
            "moe_experts": 0,
            "moe_capacity_factor": 2.0,
            "halt_on_nan": True,
            "log_every": 1,
            "steps_per_call": 0,
            "checkpoint_keep": 0,
            "trace_dir": "",
            "fuse_optimizer": True,
            "preload_dataset": True,
            "remat": False,
            "export_safetensors": True,
        }
    )


def load_yaml(filename: str) -> Dict[str, Any]:
    import yaml

    with open(filename, "r") as stream:
        return yaml.safe_load(stream) or {}


def training_config(filename: str) -> Config:
    """Load a training YAML over the defaults.  Unlike the JAX loader it
    creates no output directory: serving only reads the config."""
    return get_cfg_defaults_train().merge(load_yaml(filename))


def training_config_from_dict(d: Dict[str, Any]) -> Config:
    """Defaults merged with an in-memory dict (for tests / programmatic use)."""
    return get_cfg_defaults_train().merge(copy.deepcopy(d))


def get_model_config(config: Config) -> Dict[str, Any]:
    """Map a train config onto the model constructor kwargs.

    The same keys as ``mca_tpu.config.get_model_config``;
    ``build_model`` refuses the options this package does not
    implement yet.
    """
    return {
        "dim": config.hidden_size,
        "depth": config.layers,
        "heads": config.heads,
        "dim_head": config.dim_head,
        "ff_mult": config.ff_mult,
        "num_fusion_tokens": config.num_fusion_tokens,
        "encoder_configs": config.encoder_configs.to_plain()
        if isinstance(config.encoder_configs, Config)
        else dict(config.encoder_configs),
        "batch_size": config.batch_size,
        "fcl": config.fcl,
        "fcl_root": list(config.fcl_root),
        "bimodal_contrastive": config.bimodal_contrastive,
        "non_fusion_fcl": config.non_fusion_fcl,
        "fusion_combos": list(config.fusion_combos),
        "zorro": config.zorro,
        "eao": config.eao,
        "no_fusion": config.no_fusion,
        "mean_pool": config.mean_pool,
        "precision": config.get("precision", "bf16"),
        "attention_impl": config.get("attention_impl", "auto"),
        "remat": config.get("remat", False),
        "pipeline_stages": int(config.get("mesh_pipe", 1) or 1)
        if int(config.get("mesh_pipe", 1) or 1) > 1
        else 0,
        "pipeline_microbatches": int(
            config.get("pipeline_microbatches", 0) or 0
        ),
        "seq_shard": bool(config.get("seq_shard", False)),
        "moe_experts": int(config.get("moe_experts", 0) or 0),
        "moe_capacity_factor": float(
            config.get("moe_capacity_factor", 2.0)
        ),
        "group_channels": config.get("eao_group_channels", False),
    }
