"""The port's AOT export (``mca_tpu_torch/tools/export_aot.py``), serving
from an artifact (``EmbeddingService.from_aot``, ``serve --aot``) and the
``torch.library`` operators that carry K1's forward and K5, on the CPU:
the checks of ``tests/test_serve.py``'s export tests, with the port's own.

The program is exported on the CPU here, where the operators run their
plain versions; on the card the same operators launch the kernels.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.masks import build_masks
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops import fused_ff as port_ff
from mca_tpu_torch.serve import EmbeddingService, parse_args, service_from_args
from mca_tpu_torch.tools import export_aot

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
# the loaded program and the eager service run the same fp32 CPU code
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return training_config_from_dict(tiny_config(
        "tcga", batch_size=4, precision="fp32", attention_impl="pallas", **kw))


def _rows(n=6, seed=1):
    return make_tcga_like(n, widths=WIDTHS, p_missing=0.3, seed=seed)


def _export(tmp_path, quantize="none", cfg=None, name=None):
    cfg = cfg or _cfg()
    svc = EmbeddingService(cfg, max_batch=4, device="cpu", seed=0, quantize=quantize)
    blob, ek, mk = export_aot.export_packed_forward(
        cfg, None, svc._pad([svc._template] * 4), model=svc.model, device="cpu")
    path = tmp_path / (name or f"model_{quantize}.aot")
    export_aot.save_aot(str(path), blob, ek, mk, modality_config=cfg.modality_config.to_plain(),
                        batch=4, device="cpu", quantize=quantize)
    return svc, path


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("aot")
    return {q: _export(tmp, q) for q in ("none", "int8")}


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_export_round_trip_matches_eager(artifacts, quantize):
    svc, path = artifacts[quantize]
    fn, ek, mk = export_aot.load_aot(str(path), "cpu")
    assert ek == svc.emb_keys and mk == svc.mask_keys
    batch = svc._pad(_rows(4))
    with torch.inference_mode():
        emb, msk = fn(batch)
        want = svc._fn(batch)
    np.testing.assert_allclose(emb.numpy(), want[0].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(msk.numpy(), want[1].numpy())
    assert emb.shape == (len(ek), 4, 32) and bool(torch.isfinite(emb).all())


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_from_aot_serves_like_the_config_service(artifacts, quantize):
    svc, path = artifacts[quantize]
    aot = EmbeddingService.from_aot(str(path), device="cpu")
    assert aot.model is None and aot.quantize == quantize and aot.max_batch == 4
    rows = _rows(6)
    got, want = aot.embed(rows), svc.embed(rows)  # 4 + 2, the second chunk padded
    for k in svc.emb_keys:
        np.testing.assert_allclose(got["embeddings"][k], want["embeddings"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for m in svc.mask_keys:
        np.testing.assert_array_equal(got["present"][m], want["present"][m])
    aot.start()
    try:
        res = aot.submit(rows[1]).result(timeout=60)
    finally:
        aot.stop()
    for k in svc.emb_keys:
        np.testing.assert_allclose(res["embeddings"][k], want["embeddings"][k][1],
                                   rtol=RTOL, atol=ATOL)


def test_export_from_a_state_dict_builds_the_int8_model(artifacts, tmp_path):
    """Without ``model=``, the exporter builds the model from the config
    and the state dict, the int8 one where the state dict holds
    ``weight_q`` entries."""
    svc = artifacts["int8"][0]
    cfg = _cfg()
    blob, ek, mk = export_aot.export_packed_forward(
        cfg, svc.model.state_dict(), svc._pad([svc._template] * 4), device="cpu")
    path = tmp_path / "from_state.aot"
    export_aot.save_aot(str(path), blob, ek, mk, device="cpu")
    fn, _, _ = export_aot.load_aot(str(path), "cpu")
    batch = svc._pad(_rows(4))
    with torch.inference_mode():
        np.testing.assert_allclose(fn(batch)[0].numpy(), svc._fn(batch)[0].numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_int8_program_holds_int8_projections(artifacts):
    """The int8 program's five projections a block are int8 tensors, a
    quarter of the fp32 bytes of the weights they replace; the fp
    program holds K5's prepared weights and not the float feed-forward
    weights beside them."""
    import io

    def tensors(path):
        with open(path, "rb") as f:
            export_aot._read(f)
            program = torch.export.load(io.BytesIO(f.read()))
        return {**program.state_dict, **program.constants}

    fp, q = (tensors(artifacts[k][1]) for k in ("none", "int8"))
    q8 = [v for v in q.values() if v.dtype == torch.int8]
    assert len(q8) == 2 * 5 and sum(k.endswith(".weight_q") for k in q) == 2 * 5
    assert not any("feedforward" in k for k in fp)
    assert sum(k.endswith((".ff.w1t", ".ff.w2t")) for k in fp) == 2 * 2
    fp_weights = [v for k, v in artifacts["none"][0].model.state_dict().items()
                  if k.startswith("layers.") and k.endswith(".weight")
                  and (".attn.to_" in k or ".feedforward." in k)]
    assert len(fp_weights) == 2 * 5
    q_bytes = sum(v.numel() * v.element_size() for v in q8)
    assert 4 * q_bytes == sum(v.numel() * v.element_size() for v in fp_weights)


def test_from_aot_refuses_an_artifact_without_serving_metadata(artifacts, tmp_path):
    svc, path = artifacts["none"]
    with open(path, "rb") as f:
        export_aot._read(f)
        blob = f.read()
    bare = tmp_path / "bare.aot"
    export_aot.save_aot(str(bare), blob, svc.emb_keys, svc.mask_keys, device="cpu")
    fn, ek, _ = export_aot.load_aot(str(bare), "cpu")  # the program itself loads
    assert ek == svc.emb_keys
    with pytest.raises(ValueError, match="serving metadata"):
        EmbeddingService.from_aot(str(bare), device="cpu")


def test_loaders_refuse_each_others_artifacts(artifacts, tmp_path):
    from mca_tpu.tools import export_aot as jax_export

    jax_path = tmp_path / "jax.stablehlo"
    jax_export.save_aot(str(jax_path), b"not read", ("fusion",), ("gene",),
                        modality_config={"gene": {}}, batch=4)
    with pytest.raises(ValueError, match="JAX package artifact"):
        export_aot.load_aot(str(jax_path))
    with pytest.raises(ValueError, match="JAX package artifact"):
        EmbeddingService.from_aot(str(jax_path), device="cpu")
    with pytest.raises(AssertionError, match="not an mca AOT artifact"):
        jax_export.load_aot(str(artifacts["none"][1]))
    junk = tmp_path / "junk.aot"
    junk.write_bytes(b"0" * 64)
    with pytest.raises(ValueError, match="not an mca_tpu_torch AOT artifact"):
        export_aot.read_aot_header(str(junk))


def test_artifact_runs_on_the_device_it_was_exported_on(artifacts):
    with pytest.raises(ValueError, match="exported on cpu"):
        export_aot.load_aot_full(str(artifacts["none"][1]), device="cuda")


def test_loading_imports_no_model_code(artifacts):
    """A fresh process that imports only the service and the loader serves
    a row from the artifact without importing the config, model or
    encoder modules."""
    import os

    row = make_tcga_like(1, widths=WIDTHS, p_missing=0.0, seed=3)[0]
    plain = {m: {f: v.tolist() for f, v in d.items()} for m, d in row.items()}
    code = f"""
import json, sys
import numpy as np
from mca_tpu_torch.serve import EmbeddingService
svc = EmbeddingService.from_aot({str(artifacts["none"][1])!r}, device="cpu")
row = {{m: {{f: np.asarray(v, np.float32) for f, v in d.items()}}
       for m, d in json.loads({json.dumps(plain)!r}).items()}}
out = svc.embed([row])
print(json.dumps({{
    "loaded": sorted(m for m in sys.modules if m.startswith("mca_tpu")),
    "fusion": out["embeddings"]["fusion"][0].tolist(),
}}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for mod in ("mca_tpu_torch.models", "mca_tpu_torch.config", "mca_tpu_torch.encoders",
                "mca_tpu_torch.masks", "mca_tpu_torch.models.mca"):
        assert mod not in got["loaded"], mod
    assert not any(m == "mca_tpu" or m.startswith("mca_tpu.") for m in got["loaded"])
    assert "mca_tpu_torch.ops.flash_attention" in got["loaded"]
    want = artifacts["none"][0].embed([row])["embeddings"]["fusion"][0]
    np.testing.assert_allclose(got["fusion"], want, rtol=RTOL, atol=ATOL)


def test_cli_exports_and_serves_an_artifact(tmp_path):
    import yaml

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_config(
        "tcga", batch_size=2, precision="fp32", attention_impl="pallas")))
    out = tmp_path / "cli.aot"
    export_aot.main([str(cfg_path), "--out", str(out), "--batch", "2", "--device", "cpu",
                     "--quantize", "int8", "--allow-random-weights"])
    header = export_aot.read_aot_header(str(out))
    assert header["batch"] == 2 and header["quantize"] == "int8" and header["device"] == "cpu"
    svc = service_from_args(parse_args(["--aot", str(out), "--device", "cpu"]))
    res = svc.embed(_rows(3))
    assert all(np.isfinite(v).all() and v.shape[0] == 3 for v in res["embeddings"].values())


def test_moe_model_exports_and_serves(tmp_path):
    """The MoE feed-forward's routing (a stable sort, a gather and an
    ``index_add``) traces too; the loaded program serves what the eager
    service does."""
    svc, path = _export(tmp_path, cfg=_cfg(moe_experts=2), name="moe.aot")
    aot = EmbeddingService.from_aot(str(path), device="cpu")
    rows = _rows(4)
    got, want = aot.embed(rows), svc.embed(rows)
    for k in svc.emb_keys:
        np.testing.assert_allclose(got["embeddings"][k], want["embeddings"][k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_aot_with_quantize_is_refused(artifacts):
    with pytest.raises(ValueError, match="quantise when exporting"):
        service_from_args(parse_args(["--aot", str(artifacts["none"][1]),
                                      "--quantize", "int8", "--device", "cpu"]))


def test_entry_points_default_to_cuda_and_raise_without_it(artifacts, tmp_path):
    import inspect

    import yaml

    for fn in (EmbeddingService.from_aot, export_aot.export_packed_forward):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_config("tcga", batch_size=2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        export_aot.main([str(cfg_path), "--out", str(tmp_path / "x.aot"),
                         "--allow-random-weights"])
    with pytest.raises(RuntimeError, match="CUDA"):
        service_from_args(parse_args([str(cfg_path), "--quantize", "int8",
                                      "--allow-random-weights"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        service_from_args(parse_args(["--aot", str(artifacts["none"][1])]))
    assert not (tmp_path / "x.aot").exists()


def _flash_args(t=150, b=2, h=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, t, 64), generator=g) for _ in range(3))
    pad = torch.zeros((b, t), dtype=torch.bool)
    pad[1, t - 40:] = True
    mask = build_masks([60, 50, t - 110 - 16], 16, [3, 2]).attn_mask
    return q, k, v, pad, mask


def test_operators_pass_opcheck():
    """Schema, fake (meta) shapes and dispatch of both operators, on
    their CPU implementations."""
    q, k, v, pad, mask = _flash_args()
    sched = flash._schedule_on(mask, q.device)["pair"][:4]
    torch.library.opcheck(flash.flash_fwd_op, (q, k, v, pad, *sched, 0.125))
    torch.library.opcheck(flash.flash_fwd_op, (q, k, v, None, *sched, 0.125))
    g = torch.Generator().manual_seed(1)
    w1 = torch.randn((64, 2 * 106), generator=g) * 0.1
    w2 = torch.randn((106, 64), generator=g) * 0.1
    w1t, w2t = port_ff.prepare_geglu_weights(w1, w2, torch.float32)
    x = torch.randn((37, 64), generator=g)
    torch.library.opcheck(port_ff.geglu_ff_op, (x, w1t, w2t))


def test_operator_matches_the_plain_version_on_the_mask_its_schedule_holds():
    q, k, v, pad, mask = _flash_args()
    out, lse = flash.flash_attention(q, k, v, mask, pad, 0.125)
    ref, ref_lse = flash.flash_attention_reference(q, k, v, mask, pad, 0.125)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(150, 150), (128, 200), (2548, 2548)])
def test_mask_from_pair_schedule_inverts_pair_schedule(shape):
    rng = np.random.default_rng(shape[1])
    t, s = shape
    mask = rng.random((t, s)) < 0.3
    mask[: t // 3, s // 2:] = True  # whole tiles blocked: never visited
    got = flash.mask_from_pair_schedule(
        *(flash.pair_schedule(mask)[i] for i in (0, 1, 3)), t, s)
    np.testing.assert_array_equal(got, mask)
