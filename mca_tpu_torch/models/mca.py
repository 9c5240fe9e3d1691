"""The MCA fusion transformer's embedding forward, ported from
``mca_tpu/models/mca.py``.

One packed forward: per-modality encoders -> learnable fusion tokens
appended -> ``depth`` masked transformer blocks under the static
zorro/MCA mask and the dynamic per-sample padding mask -> fp32 final
norm -> attentive pooling into the return tokens -> the named
embeddings.  ``zorro``, ``fcl`` and ``no_fusion`` only change the
masks and the return-token layout, so they are kept.

Masks are numpy constants built once (``mca_tpu_torch.masks``); the
self-attention mask stays numpy because the flash kernel derives its
tile schedule from it, the pooling mask is a non-persistent buffer so
it moves with the module.  Parameters stay fp32; ``precision='bf16'``
runs the transformer blocks in bf16 with fp32 norms and softmax
statistics.

Not ported yet (they raise): mean pooling, pipeline / sequence
parallelism, int8 quantization, MoE, the loss graph (``no_loss=False``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from mca_tpu_torch import masks as masks_lib
from mca_tpu_torch.encoders import build_encoder
from mca_tpu_torch.losses import LOGIT_SCALE_INIT, MCAPretrainingLoss
from mca_tpu_torch.models.layers import Attention, LayerNorm, MCALayer


def dtype_of(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


class MCA(nn.Module):
    """Multimodal-contrastive-alignment fusion transformer (forward)."""

    def __init__(
        self,
        encoder_configs: Dict[str, Any],
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4,
        num_fusion_tokens: int = 16,
        fcl: bool = False,
        fusion_combos: Sequence[int] = (4, 5),
        zorro: bool = False,
        no_fusion: bool = False,
        mean_pool: bool = False,
        precision: str = "fp32",
        attention_impl: str = "dense",
        quant: str = "none",
        pipeline_stages: int = 0,
        seq_shard: bool = False,
        moe_experts: int = 0,
    ):
        super().__init__()
        if mean_pool:
            raise NotImplementedError("mean_pool is not ported yet")
        if int(pipeline_stages or 0) > 1 or seq_shard:
            raise NotImplementedError(
                "pipeline / sequence parallelism come with the "
                "parallelism slice"
            )
        self.modality_types = tuple(encoder_configs.keys())
        token_dims = [
            int(encoder_configs[m]["max_tokens"]) for m in self.modality_types
        ]
        self.mask_set = masks_lib.build_masks(
            token_dims,
            num_fusion_tokens,
            list(fusion_combos),
            zorro=zorro,
            fcl=fcl,
            no_fusion=no_fusion,
        )
        self.no_fusion = no_fusion
        self.dtype = dtype_of(precision)
        self.encoders = nn.ModuleDict(
            {
                name: build_encoder(name, cfg, dim)
                for name, cfg in encoder_configs.items()
            }
        )
        self.layers = nn.ModuleList(
            [
                MCALayer(
                    dim, dim_head, heads, ff_mult, dtype=self.dtype,
                    attn_impl=attention_impl, quant=quant,
                    moe_experts=moe_experts,
                )
                for _ in range(depth)
            ]
        )
        self.norm = LayerNorm(dim)
        if not no_fusion:
            self.fusion_tokens = nn.Parameter(
                torch.zeros(self.mask_set.num_fusion_tokens, dim)
            )
        self.return_tokens = nn.Parameter(
            torch.zeros(self.mask_set.num_return_tokens, dim)
        )
        self.attn_pool = Attention(
            dim, dim_head=dim_head, heads=heads, dtype=torch.float32,
            impl="dense",
        )
        self.register_buffer(
            "pool_mask",
            torch.from_numpy(self.mask_set.pool_mask.copy()),
            persistent=False,
        )
        self.loss = MCAPretrainingLoss(
            self.modality_types,
            do_fcl=fcl and not zorro,
            fusion_combos=self.mask_set.fusion_combos,
            no_fusion=no_fusion,
        )

    def forward(
        self,
        batch: Dict[str, Dict[str, torch.Tensor]],
        no_loss: bool = True,
    ) -> Dict[str, Any]:
        tokens, pad_masks, sample_mask = [], [], {}
        for m in self.modality_types:
            t, a = self.encoders[m](batch[m])
            tokens.append(t)
            pad_masks.append(a.bool())
            sample_mask[m] = (a == 0).sum(dim=1) != 0
        bsz = tokens[0].shape[0]
        if not self.no_fusion:
            tokens.append(
                self.fusion_tokens[None]
                .expand(bsz, -1, -1)
                .to(tokens[0].dtype)
            )
            pad_masks.append(
                torch.zeros(
                    (bsz, self.mask_set.num_fusion_tokens),
                    dtype=torch.bool,
                    device=pad_masks[0].device,
                )
            )
        x = torch.cat(tokens, dim=1).to(self.dtype)
        padding = torch.cat(pad_masks, dim=1)

        attn_mask = self.mask_set.attn_mask
        for layer in self.layers:
            x = layer(x, attn_mask, padding)
        x = self.norm(x.float())

        ret = self.return_tokens[None].expand(bsz, -1, -1)
        pooled = (
            self.attn_pool(
                ret,
                context=x,
                attn_mask=self.pool_mask,
                key_padding_mask=padding,
            )
            + ret
        )
        outputs = self.loss(pooled, sample_mask, no_loss=no_loss)
        outputs["modality_sample_mask"] = sample_mask
        return outputs

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator``, with the JAX package's
        initialisers: normal(1) token tables and fusion / return tokens,
        torch ``nn.Linear`` uniform(+-1/sqrt(fan_in)) for every linear
        weight, zeros for biases, ones for norm scales, log(1/0.07) for
        the logit scale."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("gamma") or name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name.endswith("logit_scale"):
                    p.fill_(LOGIT_SCALE_INIT)
                elif name.endswith("bias"):
                    p.zero_()
                elif name.endswith("tokens") or "embedding" in name:
                    p.copy_(torch.randn(p.shape, generator=generator))
                else:
                    bound = p.shape[1] ** -0.5  # [out, in]: fan-in
                    p.copy_(
                        torch.empty(p.shape).uniform_(
                            -bound, bound, generator=generator
                        )
                    )
        return self
