"""Config system for the PyTorch port: the same YAML surface as ``mca_tpu``.

A copy of ``mca_tpu/config.py``'s ``Config`` attribute-dict, the train
defaults, the YAML loaders and ``get_model_config``, so the port reads
the repo's configs (and the reference corpus) unchanged without
importing the JAX package.

One deliberate difference: :func:`training_config` creates no output
directory unless asked (``make_output_dir=True``, which the training
entry point passes): serving only reads a config.  With it, an empty
``output_dir`` becomes a timestamped ``training_output_*`` directory,
and the merged config is dumped there as ``config.yaml``, as the JAX
loader does by default.
"""

from __future__ import annotations

import copy
import os
from datetime import datetime
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
            "attention_impl": "auto",    # dense | pallas | segmented | auto
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


def _auto_output_dir(prefix: str = "training_output") -> str:
    """A timestamped directory name, deduplicated with ``_i``."""
    base = datetime.now().strftime(f"{prefix}_%H_%M_%d_%m_%Y")
    out = base
    i = 1
    while os.path.isdir(out):
        out = f"{base}_{i}"
        i += 1
    return out


def dump_configs(config: Config, output_dir: str) -> None:
    """Write the merged config to ``<output_dir>/config.yaml``."""
    import yaml

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(config.to_plain(), f, sort_keys=False)


def training_config(filename: str, make_output_dir: bool = False) -> Config:
    """Load a training YAML over the defaults.  ``make_output_dir``: give
    an empty ``output_dir`` a timestamped name and dump the merged
    config into it (the JAX loader's default; training passes it)."""
    config = get_cfg_defaults_train().merge(load_yaml(filename))
    if make_output_dir:
        if not config.output_dir:
            config.output_dir = _auto_output_dir()
        dump_configs(config, config.output_dir)
    return config


def training_config_from_dict(d: Dict[str, Any]) -> Config:
    """Defaults merged with an in-memory dict (for tests / programmatic use)."""
    return get_cfg_defaults_train().merge(copy.deepcopy(d))


def get_cfg_defaults_embedding_eval() -> Config:
    """Probe defaults (the same keys and values as ``mca_tpu``)."""
    return Config.from_dict(
        {
            "embedding_dir": "",
            "task": 0,
            "loss_type": "L1",
            "model_type": "linear",
            "hidden_size": 256,
            "dropout": 0.1,
            "wandb": False,
            "wandb_name": "MCA",
            "wandb_account_name": "",
            "lr": 1e-5,
            "lr_scheduler_type": "cosine",
            "num_warmup_steps": 1000,
            "rank_metrics": True,
            "epochs": 1024,
            "clip": 2.0,
            "metric": "PCC",
            "output_dir": "",
            "wandb_job_name": "MCA-DefaultJobName",
            "seed": 42,
            "batch_size": 1024,
            "threshold": 0.0,
        }
    )


def embedding_eval_config(filename: str, make_output_dir: bool = True) -> Config:
    """Load a probe YAML over the defaults; ``make_output_dir`` as in
    :func:`training_config` (on by default, as in the JAX loader)."""
    config = get_cfg_defaults_embedding_eval().merge(load_yaml(filename))
    if make_output_dir:
        if not config.output_dir:
            config.output_dir = _auto_output_dir()
        dump_configs(config, config.output_dir)
    return config


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
        "block": block_config(config),
    }


#: ``model_type`` of the DeepSeek-V3 decoder block (latent attention,
#: routed and shared experts) as the MCA fusion stack's block
DEEPSEEK_V3 = "deepseek_v3"

# the Hugging Face DeepSeek-V3 keys the block reads, and the port's own
_BLOCK_KEYS = (
    "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "rope_theta",
    "rms_norm_eps", "intermediate_size", "first_k_dense_replace", "n_routed_experts",
    "num_experts_per_tok", "moe_intermediate_size", "n_shared_experts",
    "routed_scaling_factor", "norm_topk_prob", "ep_size",
    # DeepSeek-V3's training rules (not in a config.json): the
    # sequence-wise balance loss's weight, the correction bias's step
    "aux_loss_alpha", "bias_update_speed",
)


def block_config(config: Config):
    """The ``deepseek_v3`` block's settings (``model_type: deepseek_v3``),
    or None for the MCA block.  Refuses, with a ``ValueError``, what the
    port does not run with it: a query low-rank path (``q_lora_rank``),
    another router (``scoring_func`` other than sigmoid, ``topk_method``
    other than ``noaux_tc``, expert groups), ``zorro``, ``eao``,
    ``no_fusion``, tensor parallelism (``mesh_model > 1``),
    ``seq_shard``, a pipeline (``mesh_pipe > 1``), ``remat``,
    ``quantize: int8``, ``attention_impl`` other than auto / pallas, and
    ``bwd_impl: split`` (K3a + K3b have no (192, 128) instantiation)."""
    if config.get("model_type", "mca") != DEEPSEEK_V3:
        return None
    refused = {
        "q_lora_rank": config.get("q_lora_rank") is not None,
        "scoring_func": config.get("scoring_func", "sigmoid") != "sigmoid",
        "topk_method": config.get("topk_method", "noaux_tc") != "noaux_tc",
        "n_group": int(config.get("n_group", 1) or 1) != 1
        or int(config.get("topk_group", 1) or 1) != 1,
        "zorro": bool(config.get("zorro")),
        "eao": bool(config.get("eao")),
        "no_fusion": bool(config.get("no_fusion")),
        "mesh_model": int(config.get("mesh_model", 1) or 1) > 1,
        "seq_shard": bool(config.get("seq_shard")),
        "mesh_pipe": int(config.get("mesh_pipe", 1) or 1) > 1,
        "remat": bool(config.get("remat")),
        "quantize": config.get("quantize", "none") not in ("none", None),
        "attention_impl": config.get("attention_impl", "auto") not in ("auto", "pallas"),
        "bwd_impl": config.get("bwd_impl", "fused") != "fused",
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise ValueError(
            f"model_type {DEEPSEEK_V3!r} does not run with {', '.join(bad)} as set "
            f"({', '.join(f'{k}={config.get(k)!r}' for k in bad)})"
        )
    missing = [k for k in _BLOCK_KEYS if config.get(k) is None]
    if missing:
        raise ValueError(f"model_type {DEEPSEEK_V3!r} needs {', '.join(missing)}")
    return {k: config[k] for k in _BLOCK_KEYS}
