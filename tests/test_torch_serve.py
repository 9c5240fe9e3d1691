"""The port's embedding service on the CPU (the plain versions of its
kernels): padded fixed-shape batching equals the direct forward,
micro-batching coalesces, and the HTTP front round-trips JSON — the
checks of tests/test_serve.py, on ``device="cpu"``."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.serve import EmbeddingService, make_server

torch.backends.cuda.matmul.allow_tf32 = False

# the service and the oracle run the same fp32 CPU code on a batch of
# 4 (oracle: 6 rows at once); per-sample math, so only summation order
# of batched matmuls can differ
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def service_and_oracle():
    cfg = training_config_from_dict(
        tiny_config("tcga", batch_size=4, precision="fp32")
    )
    widths = {m: c["pad_len"] for m, c in cfg.modality_config.items()}
    rows = make_tcga_like(6, widths=widths, p_missing=0.3, seed=1)
    svc = EmbeddingService(cfg, max_batch=4, device="cpu", seed=0)
    batch = {
        m: {k: torch.from_numpy(v) for k, v in f.items()}
        for m, f in svc.collate(rows).items()
    }
    with torch.inference_mode():
        oracle = svc.model(batch, no_loss=True)
    return svc, oracle, rows


def test_embed_matches_direct_forward(service_and_oracle):
    """3 rows padded to max_batch 4, then 6 rows chunked 4+2 — every
    embedding equals the direct full-batch forward."""
    svc, oracle, rows = service_and_oracle
    for n in (3, 6):
        out = svc.embed(rows[:n])
        for k in svc.emb_keys:
            np.testing.assert_allclose(
                out["embeddings"][k], oracle[k].numpy()[:n],
                rtol=RTOL, atol=ATOL,
            )
        for k in svc.mask_keys:
            np.testing.assert_array_equal(
                out["present"][k],
                oracle["modality_sample_mask"][k].numpy()[:n],
            )


def test_submit_coalesces_and_matches(service_and_oracle):
    svc, oracle, rows = service_and_oracle
    svc.start()
    try:
        futs = [svc.submit(r) for r in rows[:4]]
        results = [f.result(timeout=60) for f in futs]
    finally:
        svc.stop()
    for i, r in enumerate(results):
        for k in svc.emb_keys:
            np.testing.assert_allclose(
                r["embeddings"][k], oracle[k].numpy()[i],
                rtol=RTOL, atol=ATOL,
            )


def test_http_roundtrip(service_and_oracle):
    svc, oracle, rows = service_and_oracle
    server = make_server(svc, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=30
        ) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["max_batch"] == 4
        payload = {
            "rows": [
                {
                    m: {k: np.asarray(v).tolist() for k, v in d.items()}
                    for m, d in row.items()
                    if m != "Labels"
                }
                for row in rows[:2]
            ]
        }
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/embed",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert len(body["embeddings"]) == 2
        for i in range(2):
            np.testing.assert_allclose(
                body["embeddings"][i]["fusion"],
                oracle["fusion"].numpy()[i],
                rtol=RTOL, atol=ATOL,
            )
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


def test_embed_rejects_empty(service_and_oracle):
    svc, _, _ = service_and_oracle
    with pytest.raises(ValueError):
        svc.embed([])
