"""Online embedding serving on the GPU, ported from ``mca_tpu/serve.py``.

Serves the per-sample embeddings (modalities + fusion combos, plus
presence masks) of the MCA forward with ``no_loss=True``:

- **fixed-shape batches**: requests are padded to ``max_batch`` with
  all-pad template rows; embeddings are per-sample, so padding rows is
  numerically invisible;
- **dynamic micro-batching**: concurrent single-row requests queue and
  a batcher thread coalesces up to ``max_batch`` rows (or
  ``max_wait_ms``) into one forward, keeping one batch in flight while
  the next is collated and launched;
- **packed outputs**: one ``[E, B, D]`` embedding stack and one
  ``[M, B]`` mask stack per forward;
- a stdlib HTTP front (``POST /embed``, ``GET /healthz``).

The forward runs under ``torch.inference_mode()`` on the service's
device, through the Hopper kernels on CUDA.  The device defaults to
``cuda`` and the service raises when there is none: it never drops to
the CPU on its own (pass ``device="cpu"`` for the plain versions).

Usage::

    python -m mca_tpu_torch.serve configs/tcga_mca.yaml \\
        --allow-random-weights --port 8777
    curl -X POST :8777/embed -d '{"rows": [{"gene": {"values": [...]}, ...}]}'

Checkpoint restore (``--restart``), AOT artifacts (``--aot``) and int8
serving (``--quantize int8``) are not ported yet and raise.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mca_tpu_torch.config import get_model_config
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.models import build_model

logger = logging.getLogger(__name__)


class EmbeddingService:
    """Fixed-shape embedding forward on one device + micro-batching.

    ``params`` is a state dict under the port's (= the torch
    reference's) names, e.g. from
    :func:`mca_tpu_torch.interop.state_dict_from_jax_params`; without
    it the weights are random, drawn from ``seed``.
    """

    def __init__(
        self,
        config,
        params: Optional[Mapping[str, Any]] = None,
        restart: Optional[str] = None,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        warmup: bool = True,
        quantize: str = "none",
        device: str = "cuda",
        seed: int = 0,
    ):
        if restart:
            raise NotImplementedError(
                "restart: checkpoint restore comes with the checkpoint "
                "slice; pass params= (a state dict)"
            )
        if quantize != "none":
            raise NotImplementedError(
                "quantize: int8 serving comes with the quant slice"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the GPU; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        self.config = config
        self.model = build_model(get_model_config(config), fused_ff=True)
        if params is None:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in params.items()},
                strict=True,
            )
        self.model.to(self.device).eval()
        mods = (
            config.modality_config.to_plain()
            if hasattr(config.modality_config, "to_plain")
            else dict(config.modality_config)
        )
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.collate = MultimodalCollator(mods)
        self._template = self._zero_row(mods)
        self._queue: "queue.Queue" = queue.Queue()
        self._batcher: Optional[threading.Thread] = None
        self._stop = threading.Event()

        self.mask_keys = tuple(sorted(self.model.modality_types))
        self.emb_keys = self.model.loss.output_keys()
        if warmup:
            # builds the kernels and uploads the tile schedule, so the
            # first request pays neither
            self._materialise(self._dispatch([self._template]), 1)

    # -- request paths -------------------------------------------------

    @staticmethod
    def _zero_row(mods: Dict[str, Any]) -> Dict[str, Any]:
        """An all-pad row (template for warmup and batch padding)."""
        return {
            m: {
                c.get("data_col_name", "values"): np.full(
                    int(c["pad_len"]),
                    float(c.get("pad_token", -10000.0)),
                    np.float32,
                )
            }
            for m, c in mods.items()
        }

    def _pad(self, rows: Sequence[Dict[str, Any]]):
        """Collate ``rows`` padded to ``max_batch`` with template rows
        and copy the batch to the device."""
        assert 0 < len(rows) <= self.max_batch, len(rows)
        full = list(rows) + [self._template] * (self.max_batch - len(rows))
        return {
            m: {
                k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in fields.items()
            }
            for m, fields in self.collate(full).items()
        }

    def _dispatch(self, rows: Sequence[Dict[str, Any]]):
        """Collate + copy + launch one chunk; returns the device tensors
        without waiting for them (CUDA launches are asynchronous)."""
        with torch.inference_mode():
            out = self.model(self._pad(rows), no_loss=True)
            emb = torch.stack([out[k] for k in self.emb_keys])
            msk = torch.stack(
                [out["modality_sample_mask"][k] for k in self.mask_keys]
            )
        return emb, msk

    @staticmethod
    def _materialise(dev, n: int):
        e, m = dev
        return e[:, :n].cpu().numpy(), m[:, :n].cpu().numpy()

    def embed(self, rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Synchronous: embeddings + presence masks for ``rows``.

        Rows beyond ``max_batch`` go in chunks, software-pipelined:
        chunk i+1's collate, copy and launch are queued on the stream
        before chunk i is copied back."""
        rows = list(rows)
        if not rows:
            raise ValueError("embed() needs at least one row")
        embs: List[np.ndarray] = []
        msks: List[np.ndarray] = []
        inflight = None  # (device tensors, n_real_rows)
        for i in range(0, len(rows), self.max_batch):
            chunk = rows[i : i + self.max_batch]
            dev = self._dispatch(chunk)
            if inflight is not None:
                e, m = self._materialise(*inflight)
                embs.append(e)
                msks.append(m)
            inflight = (dev, len(chunk))
        e, m = self._materialise(*inflight)
        embs.append(e)
        msks.append(m)
        emb = np.concatenate(embs, axis=1)
        msk = np.concatenate(msks, axis=1)
        return {
            "embeddings": {k: emb[i] for i, k in enumerate(self.emb_keys)},
            "present": {
                k: msk[i].astype(bool) for i, k in enumerate(self.mask_keys)
            },
        }

    # -- micro-batching ------------------------------------------------

    def start(self) -> None:
        """Start the batcher thread (needed only for :meth:`submit`)."""
        if self._batcher is None:
            self._stop.clear()
            self._batcher = threading.Thread(
                target=self._batch_loop, daemon=True
            )
            self._batcher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._batcher is not None:
            self._batcher.join(timeout=5)
            self._batcher = None
        # fail (not strand) anything still queued
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("EmbeddingService stopped"))

    def submit(self, row: Dict[str, Any]) -> "Future":
        """Async single-row request, coalesced with concurrent requests
        into one forward by the batcher thread."""
        assert self._batcher is not None, "call start() first"
        fut: Future = Future()
        self._queue.put((row, fut))
        return fut

    def _batch_loop(self) -> None:
        """Coalesce queued rows; batch N+1 is collated and launched
        while batch N still computes, and only then is N copied back."""
        inflight = None  # (pending list, device tensors)

        def resolve(pending, dev):
            try:
                e, m = self._materialise(dev, len(pending))
                for i, (_, fut) in enumerate(pending):
                    fut.set_result(
                        {
                            "embeddings": {
                                k: e[j][i] for j, k in enumerate(self.emb_keys)
                            },
                            "present": {
                                k: bool(m[j][i])
                                for j, k in enumerate(self.mask_keys)
                            },
                        }
                    )
            except Exception as exc:  # pragma: no cover
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(exc)

        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.0 if inflight else 0.1)
                pending = [first]
            except queue.Empty:
                if inflight is not None:
                    resolve(*inflight)
                    inflight = None
                continue
            t0 = time.monotonic()
            while len(pending) < self.max_batch:
                left = self.max_wait_s - (time.monotonic() - t0)
                try:
                    pending.append(
                        self._queue.get(timeout=left)
                        if left > 0
                        else self._queue.get_nowait()
                    )
                except queue.Empty:
                    break
            try:
                dev = self._dispatch([r for r, _ in pending])
            except Exception as e:  # pragma: no cover
                for _, fut in pending:
                    if not fut.done():
                        fut.set_exception(e)
                dev = None
            if inflight is not None:
                resolve(*inflight)
            inflight = (pending, dev) if dev is not None else None
        if inflight is not None:
            resolve(*inflight)


# ---------------------------------------------------------------------------
# HTTP front (stdlib only)
# ---------------------------------------------------------------------------


def make_server(service: EmbeddingService, port: int = 0):
    """ThreadingHTTPServer on 127.0.0.1 with POST /embed + GET /healthz;
    starts the service's batcher."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.debug(fmt, *args)

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(
                    200,
                    {
                        "ok": True,
                        "max_batch": service.max_batch,
                        "embedding_keys": list(service.emb_keys),
                    },
                )
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/embed":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                futs = [service.submit(row) for row in req["rows"]]
                results = [f.result(timeout=60) for f in futs]
                self._send(
                    200,
                    {
                        "embeddings": [
                            {
                                k: np.asarray(v).tolist()
                                for k, v in r["embeddings"].items()
                            }
                            for r in results
                        ],
                        "present": [r["present"] for r in results],
                    },
                )
            except Exception as e:
                self._send(400, {"error": repr(e)})

    service.start()
    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None) -> None:
    import argparse
    import sys

    from mca_tpu_torch.config import training_config

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", help="train yaml")
    p.add_argument("--restart", default=None, help="checkpoint dir (not ported yet)")
    p.add_argument("--aot", default=None, help="AOT artifact (not ported yet)")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--quantize", choices=("none", "int8"), default="none")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--allow-random-weights",
        action="store_true",
        help="serve from random weights drawn from --seed (demo only)",
    )
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    if args.aot:
        raise NotImplementedError("--aot: AOT serving comes with the export slice")
    config = training_config(args.config)
    restart = args.restart or (config.restart or None)
    if not (restart or args.allow_random_weights):
        raise SystemExit(
            "no checkpoint: pass --restart <dir>, or --allow-random-weights "
            "for a demo server"
        )
    svc = EmbeddingService(
        config,
        restart=restart,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        quantize=args.quantize,
        device=args.device,
        seed=args.seed,
    )
    server = make_server(svc, args.port)
    logger.info(
        "serving embeddings on :%d (keys: %s)",
        server.server_address[1],
        ",".join(svc.emb_keys),
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        svc.stop()


if __name__ == "__main__":
    main()
