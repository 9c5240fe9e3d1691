"""The port's checkpoints, restart and guards, against itself, bit for
bit on the CPU (``tests/test_resume.py`` and ``tests/test_preempt.py``
are the JAX package's oracles):

- a run restarted from an epoch checkpoint, or from an
  ``n_step_checkpoint`` inside an epoch, continues the uninterrupted
  run's trajectory without replaying a step;
- ``checkpoint_keep`` prunes the older epoch directories;
- SIGTERM raised from the ``log`` callback stops the run with
  :class:`PreemptedError`, ``preempted.json`` and a root checkpoint that
  resumes the same trajectory, and the old handler comes back;
- divergence saves the state to ``diverged/``;
- ``model.safetensors`` holds the final parameters under the key set
  ``mca_tpu.interop.export_state_dict`` gives;
- serving from a checkpoint embeds as the same state dict does.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu.interop import export_state_dict
from mca_tpu.models import build_model as jax_build_model
from mca_tpu_torch import checkpoint
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.serve import EmbeddingService

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores, where per-worker thread pools
    oversubscribe them and slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StopRun(Exception):
    pass


@pytest.fixture(scope="module")
def rows():
    return make_tcga_like(40, widths=WIDTHS, p_missing=0.2, seed=0)


def _cfg(tmp_path, name, **overrides):
    cfg = training_config_from_dict(tiny_config(
        "tcga", widths=WIDTHS, batch_size=8, epochs=2, lr=2e-3, num_warmup_steps=2,
        split=0.2, attention_impl="pallas",  # 32 train rows: 4 steps an epoch
    ))
    cfg.output_dir = str(tmp_path / name)
    cfg.update(overrides)
    return cfg


def _steps(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["total_loss"]) for r in recs if "total_loss" in r]


def _final(out):
    return torch.load(os.path.join(out, "model", "model.pt"), weights_only=True)


def assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def straight(rows, tmp_path_factory):
    """Two epochs without a break: the trajectory every restart must
    continue."""
    cfg = _cfg(tmp_path_factory.mktemp("runs"), "straight")
    out = port_train.train(cfg, device="cpu", rows=rows)
    return out, _steps(out), _final(out)


def test_epoch_restart_continues_bitwise(rows, straight, tmp_path):
    out_a, steps_a, final_a = straight

    def stop_after_epoch_0(rec):
        if "val_epoch_total_loss" in rec:
            raise StopRun

    with pytest.raises(StopRun):
        port_train.train(_cfg(tmp_path, "b", checkpoint_keep=2), device="cpu", rows=rows,
                         log=stop_after_epoch_0)
    assert checkpoint.load_state(tmp_path / "b" / "0")["step"] == 4
    out_c = port_train.train(_cfg(tmp_path, "c", restart=str(tmp_path / "b" / "0")),
                             device="cpu", rows=rows)
    assert _steps(out_c) == steps_a[4:]  # steps 5-8, the same losses
    assert_params_equal(_final(out_c), final_a)


def test_mid_epoch_resume_continues_not_replays(rows, tmp_path):
    cfg_a = _cfg(tmp_path, "a", epochs=1, n_step_checkpoint=3)
    out_a = port_train.train(cfg_a, device="cpu", rows=rows)
    steps_a = _steps(out_a)
    assert [s for s, _ in steps_a] == [1, 2, 3, 4]
    assert checkpoint.load_state(out_a)["step"] == 3  # the root state
    # "crash" after step 3: restart from the root n_step checkpoint
    out_b = port_train.train(_cfg(tmp_path, "b", epochs=1, restart=out_a),
                             device="cpu", rows=rows)
    assert _steps(out_b) == steps_a[3:]  # step 4 alone, the same loss
    assert_params_equal(checkpoint.load_state(os.path.join(out_b, "0"))["model"],
                        checkpoint.load_state(os.path.join(out_a, "0"))["model"])


def test_resume_derives_start_epoch_from_restored_step(rows, straight, tmp_path):
    _, steps_a, final_a = straight
    out_a = port_train.train(_cfg(tmp_path, "a", n_step_checkpoint=3), device="cpu", rows=rows)
    assert _steps(out_a) == steps_a
    assert checkpoint.load_state(out_a)["step"] == 7  # epoch 1, 3 batches in
    out_b = port_train.train(_cfg(tmp_path, "b", restart=out_a), device="cpu", rows=rows)
    assert _steps(out_b) == steps_a[7:]  # only step 8 ran
    assert_params_equal(_final(out_b), final_a)


@pytest.mark.parametrize("keep,kept", [(1, ["2"]), (2, ["1", "2"]), (0, ["0", "1", "2"])])
def test_checkpoint_keep_prunes_old_epochs(rows, tmp_path, keep, kept):
    out = port_train.train(_cfg(tmp_path, "k", epochs=3, checkpoint_keep=keep,
                                run_eval_loop=False), device="cpu", rows=rows)
    assert sorted(d for d in os.listdir(out) if d.isdigit()) == kept
    assert checkpoint.load_state(os.path.join(out, kept[-1]))["step"] == 12


def test_sigterm_saves_a_resumable_state(rows, straight, tmp_path):
    _, steps_a, final_a = straight
    before = signal.getsignal(signal.SIGTERM)

    def sigterm_at_step_6(rec):
        if rec["step"] == 6 and "total_loss" in rec:
            signal.raise_signal(signal.SIGTERM)

    with pytest.raises(port_train.PreemptedError) as err:
        port_train.train(_cfg(tmp_path, "p"), device="cpu", rows=rows, log=sigterm_at_step_6)
    assert err.value.step == 6 and issubclass(port_train.PreemptedError, RuntimeError)
    assert signal.getsignal(signal.SIGTERM) is before  # handed back
    out = str(tmp_path / "p")
    marker = json.loads(open(os.path.join(out, "preempted.json")).read())
    assert marker["step"] == 6 and marker["epoch"] == 1 and marker["signal"] == "SIGTERM"
    assert checkpoint.load_state(out)["step"] == 6
    assert not os.path.exists(os.path.join(out, "model"))
    resumed = port_train.train(_cfg(tmp_path, "r", restart=out), device="cpu", rows=rows)
    assert _steps(resumed) == steps_a[6:]
    assert_params_equal(_final(resumed), final_a)
    # a run that completes clears its own stale marker
    port_train.train(_cfg(tmp_path, "p", restart=out), device="cpu", rows=rows)
    assert not os.path.exists(os.path.join(out, "preempted.json"))


def test_preempt_save_off_leaves_sigterm_alone(rows, tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    seen = []
    port_train.train(_cfg(tmp_path, "n", epochs=1, preempt_save=False), device="cpu",
                     rows=rows, log=lambda rec: seen.append(signal.getsignal(signal.SIGTERM)))
    assert seen and all(h is before for h in seen)


def test_divergence_saves_the_forensic_state(rows, tmp_path):
    cfg = _cfg(tmp_path, "d", lr=float("inf"), clip=0.0, num_warmup_steps=1)
    with pytest.raises(port_train.DivergenceError, match="grad_norm is nan at step 2"):
        port_train.train(cfg, device="cpu", rows=rows)
    saved = checkpoint.load_state(tmp_path / "d" / "diverged")
    assert saved["step"] == 2
    assert any(not torch.isfinite(v).all() for v in saved["model"].values())
    assert not os.path.exists(tmp_path / "d" / "model")


def test_safetensors_export_has_the_reference_keys(rows, straight):
    from safetensors.numpy import load_file

    out, _, final = straight
    got = load_file(os.path.join(out, "model.safetensors"))
    assert got.keys() == final.keys()
    for k, v in final.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    cfg_dict = tiny_config("tcga", widths=WIDTHS, batch_size=8)
    jmodel = jax_build_model(jax_model_config(jax_config(cfg_dict)))
    collate = MultimodalCollator(cfg_dict["modality_config"])
    params = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jax.tree.map(jnp.asarray, collate(rows[:8])))
    assert set(export_state_dict(params)) == set(got)


def test_safetensors_writer_round_trips_dtypes(tmp_path):
    from safetensors.torch import load_file

    sd = {
        "a": torch.randn(3, 5),
        "b": torch.randn(4).to(torch.bfloat16),
        "c": torch.tensor(2.5),
        "d": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "e": torch.tensor([True, False, True]),
    }
    path = str(tmp_path / "x.safetensors")
    checkpoint.export_safetensors(sd, path)
    got = load_file(path)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_checkpointer_reuses_its_host_buffers(tmp_path):
    saver = checkpoint.Checkpointer()
    state = {"model": {"w": torch.randn(4, 3)}, "optimizer": {"state": {0: {"m": torch.zeros(4)}},
                                                               "param_groups": [{"lr": 0.1}]},
             "step": 3, "epoch": 0}
    w0 = state["model"]["w"].clone()
    saver.save_state(state, tmp_path / "a", asynchronous=True)
    first = dict(saver._buffers)
    state["model"]["w"].add_(1.0)
    saver.save_state(state, tmp_path / "b", asynchronous=True)
    saver.wait_for_saves()
    assert saver._buffers.keys() == first.keys()
    assert all(saver._buffers[k] is first[k] for k in first)  # one host copy
    for name, want in (("a", w0), ("b", state["model"]["w"])):
        got = checkpoint.load_state(tmp_path / name)
        assert torch.equal(got["model"]["w"], want) and got["step"] == 3
        assert got["optimizer"]["param_groups"] == [{"lr": 0.1}]


def test_load_params_reads_state_or_model_dirs(straight, tmp_path):
    out, _, final = straight
    assert_params_equal(checkpoint.load_params(os.path.join(out, "1")),
                        checkpoint.load_state(os.path.join(out, "1"))["model"])
    checkpoint.save_params(final, str(tmp_path / "m"))
    assert_params_equal(checkpoint.load_params(str(tmp_path / "m")), final)
    with pytest.raises(FileNotFoundError, match="neither"):
        checkpoint.load_params(str(tmp_path / "nothing"))


@pytest.mark.parametrize("which", ["1", "model"])
def test_service_serves_a_checkpoint_as_its_state_dict(rows, straight, tmp_path, which):
    out, _, final = straight
    cfg = _cfg(tmp_path, "s")
    if which == "model":  # a directory that holds only the final model
        restart = str(tmp_path / "final")
        checkpoint.save_params(final, restart)
        params = final
    else:
        restart = os.path.join(out, which)
        params = checkpoint.load_state(restart)["model"]
    from_ckpt = EmbeddingService(cfg, restart=restart, device="cpu", max_batch=8, warmup=False)
    direct = EmbeddingService(cfg, params=params, device="cpu", max_batch=8, warmup=False)
    query = [{m: r[m] for m in WIDTHS} for r in rows[:5]]
    a, b = from_ckpt.embed(query), direct.embed(query)
    for k in direct.emb_keys:
        np.testing.assert_array_equal(a["embeddings"][k], b["embeddings"][k], err_msg=k)
    with pytest.raises(ValueError, match="not both"):
        EmbeddingService(cfg, params=params, restart=restart, device="cpu", warmup=False)
