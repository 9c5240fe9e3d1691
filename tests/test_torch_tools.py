"""The port's ``tools/attention_maps``, ``tools/import_checkpoint``,
``tools/gen_corpus``, ``tools/reproduce`` and ``tools/sweep`` on the
CPU, against the JAX package's tools at tiny shapes.

- ``attention_maps``: the ``.npz`` keys and arrays equal JAX's
  ``extract_attention_maps`` on the same weights and batch (fp32, 1e-5).
- ``import_checkpoint --with-optimizer``: an Accelerate directory written
  here (reference-named weights, a torch AdamW state with random moments,
  the scheduler's step); one step restarted from the port's import equals
  JAX's import-then-step (loss and parameters, fp32, 1e-5 relative, the
  parameters with a 1e-6 absolute floor).
- ``gen_corpus``: the same files, byte for byte, each loading through
  the port's config loaders.
- ``reproduce`` and a one-cell ``sweep``: end to end with the JAX tools'
  artefacts and keys (the sweep row against the JAX package's committed
  row of the same cell); the sweep's resume skips fire on the files the
  port's own stages write.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu_torch import checkpoint
from mca_tpu_torch.config import embedding_eval_config, training_config
from mca_tpu_torch.data.synthetic import to_hf_dataset
from mca_tpu_torch.interop import state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = {"gene": 6, "protein": 5, "methylation": 4, "mirna": 3}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(**kw):
    return tiny_config("tcga", widths=WIDTHS, batch_size=4, **kw)


def _write_yaml(path, d):
    path.write_text(yaml.safe_dump(d, sort_keys=False))
    return str(path)


def _jax_params(d, seed=0):
    jcfg = jax_config(d)
    model = jax_build_model(jax_model_config(jcfg))
    batch = JaxCollator(jcfg.modality_config.to_plain())(
        make_tcga_like(4, widths=WIDTHS, p_missing=0.3, seed=7))
    params = jax.jit(model.init)(jax.random.key(seed), jax.tree.map(jnp.asarray, batch))
    return jcfg, model, params


# -- attention_maps -----------------------------------------------------------


def test_attention_maps_match_jax(tmp_path, monkeypatch):
    import mca_tpu.infer as jax_infer
    from mca_tpu.tools.attention_maps import extract_attention_maps as jax_maps
    from mca_tpu_torch.tools import attention_maps

    ds = tmp_path / "ds"
    to_hf_dataset(make_tcga_like(12, widths=WIDTHS, p_missing=0.3, seed=1)).save_to_disk(str(ds))
    d = _cfg_dict(dataset=str(ds), restart=str(tmp_path / "ckpt"))
    jcfg, _, params = _jax_params(d)
    monkeypatch.setattr(jax_infer, "_restore_params", lambda path, target: params)
    want = jax_maps(jcfg)
    checkpoint.save_params(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
                           str(tmp_path / "ckpt"))
    out = tmp_path / "maps.npz"
    attention_maps.main([_write_yaml(tmp_path / "cfg.yaml", d), "--out", str(out),
                         "--device", "cpu"])
    got = dict(np.load(out))
    assert sorted(got) == sorted(want) == ["layers", "pool", "token_types"]
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["layers"].sum(-1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="EAO"):
        attention_maps.extract_attention_maps(
            training_config(_write_yaml(tmp_path / "eao.yaml", dict(
                d, eao=True, no_fusion=True, mean_pool=True, fcl_root=[0, 1],
                fusion_combos=[2]))), device="cpu")


# -- import_checkpoint ---------------------------------------------------------

LR, WARMUP, N_TOTAL, K_SAVE = 1e-3, 2, 7, 5


def _accelerate_dir(root, params, modalities):
    """A reference-format ``save_state`` directory holding ``params``."""
    from mca_tpu.interop import export_state_dict, ref_param_names

    sd = export_state_dict(params)
    root.mkdir()
    torch.save({k: torch.tensor(np.array(v)) for k, v in sd.items()}, root / "pytorch_model.bin")
    names = ref_param_names(params, modalities=modalities)
    rng = np.random.default_rng(0)

    def moment(shape, scale):
        return torch.tensor(np.asarray(scale * rng.standard_normal(shape), np.float32))

    state = {i: {"step": torch.tensor(float(K_SAVE)),
                 "exp_avg": moment(np.shape(sd[n]), 1e-3),
                 "exp_avg_sq": moment(np.shape(sd[n]), 1e-3).square()}
             for i, n in enumerate(names) if n != "norm.gamma"}  # one never stepped
    torch.save({"state": state, "param_groups": [{"params": list(range(len(names))),
                                                  "lr": LR}]}, root / "optimizer.bin")
    torch.save({"last_epoch": K_SAVE}, root / "scheduler.bin")


def test_import_checkpoint_restart_step_matches_jax(tmp_path):
    """JAX: import weights, moments and step, then one step; the port:
    ``import_checkpoint --with-optimizer``, then one step restarted from
    what it wrote, as ``restart:`` loads it."""
    from mca_tpu.interop import (fill_adam_state, import_optimizer_state,
                                 import_state_dict, load_accelerate_dir)
    from mca_tpu.train import hf_lr_schedule, make_optimizer, make_train_step
    from mca_tpu_torch import train as port_train
    from mca_tpu_torch.tools import import_checkpoint

    d = _cfg_dict(lr=LR, num_warmup_steps=WARMUP, fuse_optimizer=False)
    jcfg, jmodel, params = _jax_params(d, seed=3)
    _accelerate_dir(tmp_path / "acc", params, list(WIDTHS))
    batch_np = JaxCollator(jcfg.modality_config.to_plain())(
        make_tcga_like(4, widths=WIDTHS, p_missing=0.25, seed=11))

    saved = load_accelerate_dir(str(tmp_path / "acc"))
    jparams, _ = import_state_dict(saved["model"], params)
    mu, nu, _ = import_optimizer_state(saved["optimizer"], jparams, modalities=list(WIDTHS),
                                       model_sd=saved["model"])
    tx = make_optimizer(jcfg, N_TOTAL)
    state = {"params": jax.tree.map(jnp.asarray, jparams),
             "opt_state": fill_adam_state(tx.init(jparams), mu, nu, saved["scheduler_step"]),
             "step": jnp.asarray(saved["scheduler_step"], jnp.int32)}
    step_fn = make_train_step(jmodel, tx, hf_lr_schedule("cosine", LR, WARMUP, N_TOTAL))
    state, metrics = step_fn(state, jax.tree.map(jnp.asarray, batch_np))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, state["params"]))

    cfg_path = _write_yaml(tmp_path / "cfg.yaml", d)
    out = tmp_path / "imported"
    assert import_checkpoint.main([cfg_path, str(tmp_path / "acc"), str(out),
                                   "--with-optimizer", "--export",
                                   str(tmp_path / "w.safetensors")]) == 0
    cfg = training_config(cfg_path)
    restored = checkpoint.load_state(str(out))
    assert restored["step"] == K_SAVE
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=N_TOTAL)
    port_train.load_train_state(restored, model, opt, sched)
    got = port_train.train_step(model, opt, sched, port_train.to_device(batch_np, "cpu"),
                                clip=float(cfg.clip))
    np.testing.assert_allclose(got["total_loss"], float(metrics["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["lr"], float(hf_lr_schedule("cosine", LR, WARMUP,
                                                               N_TOTAL)(K_SAVE)), rtol=1e-6)
    for name, p in model.named_parameters():
        # an absolute floor at a thousandth of the step's update (lr 1e-3 x
        # the schedule): the gradients sum in another order
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    exported = checkpoint.read_safetensors(str(tmp_path / "w.safetensors"))
    for k, v in saved["model"].items():
        np.testing.assert_array_equal(exported[k].numpy(), v)


# -- gen_corpus ----------------------------------------------------------------


def test_gen_corpus_matches_jax_and_loads(tmp_path):
    from mca_tpu.tools import gen_corpus as jax_corpus
    from mca_tpu_torch.tools import gen_corpus

    n = gen_corpus.write_corpus(str(tmp_path / "port"), "runs")
    assert n == jax_corpus.write_corpus(str(tmp_path / "jax"), "runs")
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) == n
    for name in files:
        path = tmp_path / "port" / name
        assert path.read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
        if name.endswith("_eval.yaml"):
            cfg = embedding_eval_config(str(path), make_output_dir=False)
            assert cfg.embedding_dir.startswith("runs/")
        else:
            cfg = training_config(str(path))
            assert cfg.output_dir.startswith("runs/") and cfg.layers == 5


# -- reproduce -----------------------------------------------------------------


def test_reproduce_end_to_end(tmp_path):
    """The JAX tool's pipeline schema through the port on the CPU: a
    synthetic preprocess, two epochs, infer from the last, a probe."""
    from mca_tpu_torch.tools import reproduce

    pipeline = {
        "preprocess": {"synthetic": {"kind": "tcga", "n_samples": 24, "widths": WIDTHS,
                                     "clustered": True, "n_classes": 3, "seed": 0},
                       "out": str(tmp_path / "ds")},
        "train": dict(_cfg_dict(epochs=2, output_dir=str(tmp_path / "run"))),
        "infer_epoch": -1,
        "probe": {"task": -1, "loss_type": "BCE", "epochs": 8, "batch_size": 16,
                  "rank_metrics": True},
    }
    path = tmp_path / "pipeline.yaml"
    path.write_text(yaml.safe_dump(pipeline, sort_keys=False))
    summary = reproduce.reproduce(reproduce._load_yaml(str(path)), device="cpu")
    # the JAX tool's summary keys
    assert list(summary) == ["dataset", "train_output", "inference", "probe"]
    assert summary["train_output"] == str(tmp_path / "run")
    for epoch in (0, 1):
        assert (tmp_path / "run" / str(epoch) / "state" / "state.pt").exists()
    from mca_tpu_torch.infer import output_files

    assert all(os.path.exists(p) for p in output_files(summary["inference"]))
    assert {"train_loss", "eval_loss", "eval_f1", "eval_auroc"} <= set(summary["probe"])
    assert all(np.isfinite(v) for v in summary["probe"].values())
    assert (tmp_path / "run" / "probe" / "metrics.jsonl").exists()


# -- sweep ---------------------------------------------------------------------


def test_sweep_configs_and_cells_are_jax(tmp_path):
    from mca_tpu.tools import sweep as jax_sweep
    from mca_tpu_torch.tools import sweep

    assert [sweep.cell_id(c) for c in sweep.default_cells()] == \
        [jax_sweep.cell_id(c) for c in jax_sweep.default_cells()]
    for cell in sweep.default_cells():
        kw = dict(dataset="ds", output_dir="out", epochs=3, widths=WIDTHS, n_samples=40)
        tr = sweep.make_train_yaml(cell, **kw)
        assert tr == jax_sweep.make_train_yaml(cell, **kw)
        ik = dict(restart="out/2", output_dir="inf", infer_dropout=cell.get("infer_dropout"))
        assert sweep.make_infer_yaml(tr, **ik) == jax_sweep.make_infer_yaml(tr, **ik)
    ek = dict(embedding_dir="inf", output_dir="probe", epochs=20)
    assert sweep.make_eval_yaml(**ek) == jax_sweep.make_eval_yaml(**ek)


def test_sweep_one_cell_end_to_end_and_resume(tmp_path, monkeypatch):
    """One cell (``mca_d00``) at the tiny scale through the CLI: the row
    carries the JAX package's keys, and a rerun of the cell skips every
    stage on the port's own files; with one of infer's files gone, infer
    runs again."""
    import mca_tpu_torch.infer as port_infer
    import mca_tpu_torch.probe as port_probe
    import mca_tpu_torch.train as port_train
    from mca_tpu_torch.tools import sweep

    out = tmp_path / "sweep"
    argv = ["--out", str(out), "--tiny", "--cells", "mca_d00", "--epochs", "1",
            "--probe-epochs", "20", "--n-samples", "48", "--device", "cpu"]
    sweep.main(argv)
    rows = [json.loads(line) for line in open(out / "sweep_grid.jsonl")]
    assert [r["cell"] for r in rows] == ["mca_d00"]
    with open(os.path.join(ROOT, "baselines", "sweep_grid.jsonl")) as f:
        jax_row = next(r for r in map(json.loads, f) if r["cell"] == "mca_d00")
    row = rows[0]
    assert sorted(row) == sorted(jax_row)
    assert sorted(row["probe"]) == sorted(jax_row["probe"])
    assert sorted(row["retrieval"]) == sorted(jax_row["retrieval"])
    assert row["configs"] == {"train": "configs/TCGA_sweep_mca_d00.yaml",
                              "infer": "configs/TCGA_sweep_mca_d00_0i.yaml",
                              "eval": "configs/TCGA_sweep_mca_d00_0i_eval.yaml"}
    assert row["device"] == "cpu" and np.isfinite(row["final_train_loss"])
    assert "mca_d00" in (out / "SWEEP_GRID.md").read_text()

    # the stages' resume skips: nothing reruns while its files are there
    def refuse(*a, **k):
        raise AssertionError("a stage ran again")

    called = []
    monkeypatch.setattr(port_train, "train", refuse)
    monkeypatch.setattr(port_probe, "probe", refuse)
    monkeypatch.setattr(port_infer, "infer", lambda cfg, *a, **k: called.append(cfg.output_dir))
    (out / "sweep_grid.jsonl").unlink()
    sweep.main(argv)
    assert called == []
    os.remove(port_infer.output_files(str(out / "runs" / "mca_d00_infer"))[-1])
    (out / "sweep_grid.jsonl").unlink()
    sweep.main(argv)
    assert called == [str(out / "runs" / "mca_d00_infer")]


def test_tools_default_to_cuda_and_raise_without_it(tmp_path):
    """The new entry points run on the GPU unless the CPU is asked for,
    and raise without one before reading data."""
    import inspect

    from mca_tpu_torch.tools import attention_maps, reproduce, sweep

    for fn in (attention_maps.extract_attention_maps, reproduce.reproduce, sweep.run_train,
               sweep.run_infer, sweep.run_probe, sweep.run_sweep):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg_path = _write_yaml(tmp_path / "cfg.yaml", _cfg_dict(dataset=str(tmp_path / "none")))
    with pytest.raises(RuntimeError, match="CUDA"):
        attention_maps.main([cfg_path])
    with pytest.raises(RuntimeError, match="CUDA"):
        reproduce.reproduce({"train": _cfg_dict(output_dir=str(tmp_path / "run"))},
                            rows=make_tcga_like(8, widths=WIDTHS))
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(["--out", str(tmp_path / "sweep"), "--tiny", "--cells", "mca_d00",
                    "--n-samples", "16"])
