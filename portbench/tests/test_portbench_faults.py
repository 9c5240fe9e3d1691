"""A run with the timed path broken underneath must come out with
``correct`` false: a step that leaves the state unchanged, half of the
batch left out (the mean taken over the rest), an answer altered where
it is produced, and the gradients' exchange between ranks left out.
The runs are the CPU rehearsal's (the look for a card skipped)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.tests.conftest import CHECKOUT, DATA


def run_here(capsys, workload, seed=2**31 + 5):
    from portbench import run

    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "1", "--trace", "0",
                   "--device", "cpu", "--bench", str(DATA / "bench.json"), "--data", str(DATA)])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    assert run_here(capsys, "tiny_tab.train")["correct"] is True


def test_step_that_leaves_the_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    line = run_here(capsys, "tiny_tab.train")
    assert line["correct"] is False
    assert line["checks"]["update_gap"]["value"] > line["checks"]["update_gap"]["limit"]


def test_half_of_the_batch_left_out(capsys, monkeypatch):
    import mca_tpu_torch.train as train

    whole = train.to_device

    def half(batch, device):
        out = whole(batch, device)
        return {m: {k: v[: len(v) // 2] for k, v in f.items()} for m, f in out.items()}

    monkeypatch.setattr(train, "to_device", half)
    assert run_here(capsys, "tiny_tab.train")["correct"] is False


def test_answer_altered_where_it_is_produced(capsys, monkeypatch):
    from mca_tpu_torch.serve import EmbeddingService

    made = EmbeddingService._materialise

    def altered(dev, n):
        e, m = made(dev, n)
        return e * 1.05, m

    monkeypatch.setattr(EmbeddingService, "_materialise", staticmethod(altered))
    line = run_here(capsys, "tiny_tab.serve")
    assert line["correct"] is False
    assert line["checks"]["emb_gap"]["value"] > line["checks"]["emb_gap"]["limit"]


def test_exchange_between_ranks_left_out(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(
        "from mca_tpu_torch.parallel import sharding\n"
        "sharding.ShardedOptimizer.reduce_gradients = lambda self: None\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(CHECKOUT)]))
    p = subprocess.run(
        [sys.executable, str(CHECKOUT / "portbench" / "run.py"), "--workload", "tiny_tab.train.dp2",
         "--seed", "9", "--seconds", "1", "--trace", "0", "--device", "cpu",
         "--bench", str(DATA / "bench.json"), "--data", str(DATA)],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    p = subprocess.run(
        [sys.executable, str(CHECKOUT / "portbench" / "run.py"), "--workload", "tcga_mca.train.b64",
         "--seed", "2147483700", "--seconds", "3", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
