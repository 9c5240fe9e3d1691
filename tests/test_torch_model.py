"""The port's MCA embedding forward against the JAX package.

A JAX ``MCA`` is initialised at a tiny TCGA shape (4 tabular
modalities of widths 12/8/10/6, 2 fusion tokens per combo, dim 32,
depth 2, 2 heads x 16); its parameters are carried into the port with
``state_dict_from_jax_params`` and ``load_state_dict(strict=True)``.
The JAX side runs with ``attention_impl='pallas'`` and
``MCA_FUSED_FF=1``, so both Pallas kernels run in interpret mode; the
port runs on the CPU, through the plain versions of its two kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu import masks as jax_masks
from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu_torch import masks as torch_masks
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import build_model

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _cfg(precision):
    return tiny_config(
        "tcga", batch_size=4, precision=precision, attention_impl="pallas"
    )


def _rows():
    widths = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
    rows = make_tcga_like(4, widths=widths, p_missing=0.0, seed=3)
    rows[1]["protein"]["values"][:] = -10000.0  # a missing modality
    rows[2]["gene"]["values"][9:] = -10000.0  # a ragged tail
    return rows


def _jax_and_port(monkeypatch, precision):
    monkeypatch.setenv("MCA_FUSED_FF", "1")
    d = _cfg(precision)
    jcfg = jax_config(d)
    jmodel = jax_build_model(jax_model_config(jcfg))
    rows = _rows()
    batch_np = JaxCollator(jcfg.modality_config.to_plain())(rows)
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch_j)
    params_np = jax.tree.map(np.asarray, params)
    jout = jax.jit(lambda p, b: jmodel.apply(p, b, no_loss=True))(params, batch_j)

    cfg = training_config_from_dict(d)
    model = build_model(get_model_config(cfg))
    model.load_state_dict(state_dict_from_jax_params(params_np), strict=True)
    model.eval()
    batch_t = {
        m: {k: torch.from_numpy(v) for k, v in f.items()}
        for m, f in MultimodalCollator(cfg.modality_config.to_plain())(
            rows
        ).items()
    }
    with torch.inference_mode():
        tout = model(batch_t, no_loss=True)
    return jout, tout


@pytest.mark.parametrize(
    "precision,rtol,atol",
    [
        # fp32: the same arithmetic in another summation order; the
        # embeddings are O(1), so 1e-4 relative is order noise
        ("fp32", 1e-4, 1e-5),
        # bf16: both round activations to bf16 (8-bit mantissa, 4e-3
        # relative) but at different places (XLA fuses some casts
        # away); through two blocks the gap stays within a bf16 ulp of
        # the O(1) embeddings
        ("bf16", 1e-2, 4e-3),
    ],
)
def test_forward_matches_jax(monkeypatch, precision, rtol, atol):
    jout, tout = _jax_and_port(monkeypatch, precision)
    keys = sorted(k for k in jout if k != "modality_sample_mask")
    assert keys == sorted(k for k in tout if k != "modality_sample_mask")
    for k in keys:
        np.testing.assert_allclose(
            tout[k].float().numpy(), np.asarray(jout[k], np.float32),
            rtol=rtol, atol=atol, err_msg=k,
        )
    for m, present in jout["modality_sample_mask"].items():
        np.testing.assert_array_equal(
            tout["modality_sample_mask"][m].numpy(), np.asarray(present)
        )
    assert not tout["modality_sample_mask"]["protein"][1]


@pytest.mark.parametrize(
    "dims,fusion,combos",
    [
        ([800, 198, 800, 662], 88, [4, 3, 2]),  # TCGA_config1
        ([12, 8, 10, 6], 22, [4, 3, 2]),  # the tiny test shape
    ],
)
@pytest.mark.parametrize("zorro", [False, True])
def test_build_masks_equal(dims, fusion, combos, zorro):
    a = jax_masks.build_masks(dims, fusion, combos, fcl=True, zorro=zorro)
    b = torch_masks.build_masks(dims, fusion, combos, fcl=True, zorro=zorro)
    for field in ("token_types", "return_token_types", "attn_mask", "pool_mask"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.fusion_combos == b.fusion_combos


def test_state_dict_names_match_module():
    """The carried state dict has exactly the module's parameter names
    (the strict-load bridge), and no persistent buffers sneak in."""
    cfg = training_config_from_dict(_cfg("fp32"))
    model = build_model(get_model_config(cfg))
    names = set(model.state_dict())
    assert "layers.0.ff.feedforward.0.weight" in names
    assert "loss.loss_fn.logit_scale" in names
    assert "encoders.gene.value_encoder.norm.bias" in names
    assert names == {n for n, _ in model.named_parameters()}
