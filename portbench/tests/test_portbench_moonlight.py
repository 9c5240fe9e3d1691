"""The ``deepseek_v3`` cell's files: the configuration keeps every
number of Moonlight-16B-A3B's published ``config.json`` but the cut
ones, the counts add up from the shapes, the driver runs the tiny
rehearsal of the cell on the CPU untraced and traced, and (on the card)
the fp8 control comes out not correct where the program comes out
correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import counts, moonlight_counts
from portbench.tests.conftest import CHECKOUT, DATA

# https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json
PUBLISHED = {
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 11264, "kv_lora_rank": 512,
    "max_position_embeddings": 8192, "model_type": "deepseek_v3", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "norm_topk_prob": True, "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "num_nextn_predict_layers": 0,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05,
    "rope_theta": 50000, "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 163840,
}
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def test_the_configuration_keeps_the_published_numbers():
    entry = next(c for c in BENCH["configs"] if c["name"] == "tcga_moonlight")
    cfg = json.loads((CHECKOUT / entry["file"]).read_text())
    changed = {k for k, v in PUBLISHED.items() if cfg.get(k, "missing") != v}
    assert changed == {"num_hidden_layers", "ep_size"} <= set(entry["reduced"])
    assert cfg["num_hidden_layers"] == cfg["layers"] == 5 and cfg["ep_size"] == 8
    assert set(entry["reduced"]) == set(cfg["meta"]["changed"])
    assert {"aux_loss_alpha", "bias_update_speed", "positions"} <= set(cfg["meta"]["assumed"])


def test_counts_add_up_from_the_shapes():
    cfg = json.loads((DATA / "tiny_moonlight.json").read_text())
    live = counts.live_entries(cfg)
    assert moonlight_counts.mla_attn_fwd_work(cfg, 3)[0] == 2 * (24 + 16) * live * 3 * 2
    assert moonlight_counts.mla_attn_bwd_work(cfg, 3)[0] == 2 * (3 * 24 + 2 * 16) * live * 3 * 2
    # one assignment: W1 (64 -> 48) and W2 (24 -> 64), forward and twice backward
    assert moonlight_counts.expert_gemm_work(cfg, 1)[0] == 3 * (2 * 64 * 48 + 2 * 24 * 64)
    t = counts.sample_tokens(cfg)
    assert moonlight_counts.balanced_assignments(cfg, 4) == 4 * t * 2 * 4 / 8
    assert moonlight_counts.train_flops(cfg, 4) == 3 * moonlight_counts.forward_flops(cfg, 4)


def run_tiny(trace):
    argv = [sys.executable, str(CHECKOUT / "portbench" / "run.py"), "--workload",
            "tiny_moonlight.train", "--seed", str(2**31 + 99), "--seconds", "1", "--trace",
            str(trace), "--bench", str(DATA / "bench_moonlight.json"), "--data", str(DATA),
            "--device", "cpu"]
    p = subprocess.run(argv, cwd=CHECKOUT, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    return p, json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_cell_runs_on_the_cpu(trace):
    p, line = run_tiny(trace)
    assert line["correct"] is True and line["attempted"] > 0
    assert "routed assignments flipped" in p.stdout
    if trace:
        # the counters are the program's; the device readings need a card
        assert set(line["metrics"]) == {"expert_load_ratio.train"}
        assert 1.0 <= line["metrics"]["expert_load_ratio.train"]["value"] <= 4.0
    else:
        assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s"}


@pytest.mark.card
def test_the_control_is_not_correct_where_the_program_is(card):
    """One seed of the real cell on the card, through the control tool."""
    seed = "2147483711"
    p = subprocess.run([sys.executable, str(CHECKOUT / "portbench/tools/moonlight_control.py"),
                        "--workload", "tcga_moonlight.train.b32", "--seeds", seed,
                        "--control-seeds", seed], cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=3000)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["wrong_verdicts"] == [] and np.isfinite(
        summary["summary"]["loss_gap"]["program_max"])
