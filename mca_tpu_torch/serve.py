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

``--restart DIR`` (``restart=``) serves the parameters of a training
checkpoint: a train-state directory (``output_dir`` or
``output_dir/<epoch>``) or the final ``output_dir``'s ``model``
(:func:`mca_tpu_torch.checkpoint.load_params`).  ``--quantize int8``
(``quantize="int8"``) serves the five block projections on int8 weights
made from the fp32 ones (:mod:`mca_tpu_torch.ops.quant`), as
``mca_tpu.serve`` does.  ``--aot model.aot``
(:meth:`EmbeddingService.from_aot`) serves a
``mca_tpu_torch.tools.export_aot`` artifact without the YAML, the
checkpoint or the model code: that path imports only the collator and
the modules that register the kernels' operators.
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

from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.staging import to_device
from mca_tpu_torch.ops.quant import QUANT_MODES
from mca_tpu_torch.utils import trace

logger = logging.getLogger(__name__)


def pack_outputs(out: Mapping[str, Any], emb_keys: Sequence[str],
                 mask_keys: Sequence[str]):
    """A ``no_loss`` forward's outputs as one ``[E, B, D]`` embedding
    stack and one ``[M, B]`` mask stack, in the given key orders."""
    emb = torch.stack([out[k] for k in emb_keys])
    msk = torch.stack([out["modality_sample_mask"][k] for k in mask_keys])
    return emb, msk


class EmbeddingService:
    """Fixed-shape embedding forward on one device + micro-batching.

    ``params`` is a state dict under the port's (= the torch
    reference's) names, e.g. from
    :func:`mca_tpu_torch.interop.state_dict_from_jax_params`; without
    it the weights are random, drawn from ``seed``.  ``restart`` (a
    checkpoint directory) takes the parameters from there instead.
    ``quantize="int8"`` quantises those fp32 weights for the int8 model.
    :meth:`from_aot` builds a service from an exported artifact instead.
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
        from mca_tpu_torch import checkpoint
        from mca_tpu_torch.config import get_model_config
        from mca_tpu_torch.models import build_model
        from mca_tpu_torch.ops.quant import quantize_state_dict

        if restart and params is not None:
            raise ValueError("pass params= or restart=, not both")
        if quantize not in QUANT_MODES:
            raise ValueError(f"quantize must be one of {QUANT_MODES}, got {quantize!r}")
        mods = (
            config.modality_config.to_plain()
            if hasattr(config.modality_config, "to_plain")
            else dict(config.modality_config)
        )
        self._common_init(mods, max_batch, max_wait_ms, device)
        self.config = config
        mc = get_model_config(config)
        with trace.span("build.model"):
            model = build_model(mc, fused_ff=True)
        with trace.span("build.weights"):
            if restart:
                params = checkpoint.load_params(restart)
            if params is None:
                model.init_weights(torch.Generator().manual_seed(seed))
            else:
                model.load_state_dict(
                    {k: torch.as_tensor(v) for k, v in params.items()},
                    strict=True,
                )
            if quantize != "none":
                # post-training int8 of the fp32 weights, as mca_tpu.serve
                # quantises its restored tree; the fp model is dropped
                fp_state = model.state_dict()
                model = build_model(dict(mc, quant=quantize), fused_ff=True)
                model.load_state_dict(quantize_state_dict(fp_state), strict=True)
        self.quantize = quantize
        with trace.span("build.move"):
            self.model = model.to(self.device).eval()
        self.mask_keys = tuple(sorted(self.model.modality_types))
        self.emb_keys = self.model.loss.output_keys()
        self._fn = lambda batch: pack_outputs(
            self.model(batch, no_loss=True), self.emb_keys, self.mask_keys
        )
        if warmup:
            # builds the kernels and uploads the tile schedule, so the
            # first request pays neither
            self._warmup()

    def _common_init(self, mods: Dict[str, Any], max_batch: int,
                     max_wait_ms: float, device: str) -> None:
        """Runtime fields of both ways to build a service (from a config
        and :meth:`from_aot`): a field added here cannot drift between
        them."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port serves on the GPU; pass "
                "device='cpu' to run the plain versions on the CPU"
            )
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.collate = MultimodalCollator(mods)
        self._template = self._zero_row(mods)
        self._queue: "queue.Queue" = queue.Queue()
        self._batcher: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _warmup(self) -> None:
        """One padded forward, so that the first request pays neither a
        kernel build nor a schedule upload."""
        with trace.span("build.warmup"):
            self._materialise(self._dispatch([self._template]), 1)

    @classmethod
    def from_aot(
        cls,
        path: str,
        max_wait_ms: float = 5.0,
        warmup: bool = True,
        device: str = "cuda",
    ) -> "EmbeddingService":
        """Serve a ``tools.export_aot`` artifact: the forward and its
        weights come from the exported program, the collator and the
        request padding from the artifact's header; no YAML, model code
        or checkpoint is read.  The artifact runs on the device type it
        was exported on."""
        from mca_tpu_torch.tools.export_aot import load_aot_full, read_aot_header

        header = read_aot_header(path)
        mods = header.get("modality_config")
        if not mods or not header.get("batch"):
            raise ValueError(
                "artifact lacks serving metadata (modality_config / batch): "
                "export it again with mca_tpu_torch.tools.export_aot"
            )
        self = object.__new__(cls)
        self._common_init(mods, int(header["batch"]), max_wait_ms, device)
        fn, header = load_aot_full(path, device=device)
        self.config = None
        self.model = None
        self.quantize = header.get("quantize", "none")
        self.emb_keys = tuple(header["emb_keys"])
        self.mask_keys = tuple(header["mask_keys"])
        self._fn = fn
        if warmup:
            self._warmup()
        return self

    # -- request paths -------------------------------------------------

    @staticmethod
    def _zero_row(mods: Dict[str, Any]) -> Dict[str, Any]:
        """An all-pad row (template for warmup and batch padding), as
        ``mca_tpu.serve`` builds it: ``[pad_len]`` of ``pad_token`` for a
        ``sequence`` modality; ``[pad_len, width]`` for ``matrix`` (of
        ``pad_token``) and ``embedded_sequence`` (of finite zeros: its
        collator's attention mask carries the padding).  The width is the
        config's ``embedding_size``, ``input_size`` or ``width``, else 1
        (the collators widen to the first real row's width)."""
        row: Dict[str, Any] = {}
        for m, c in mods.items():
            field = c.get("data_col_name", "values")
            pad = float(c.get("pad_token", -10000.0))
            typ = c.get("type")
            if typ in ("matrix", "embedded_sequence"):
                width = int(c.get("embedding_size") or c.get("input_size")
                            or c.get("width") or 1)
                fill = 0.0 if typ == "embedded_sequence" else pad
                row[m] = {field: np.full((int(c["pad_len"]), width), fill, np.float32)}
            else:
                row[m] = {field: np.full(int(c["pad_len"]), pad, np.float32)}
        return row

    def _pad(self, rows: Sequence[Dict[str, Any]]):
        """Collate ``rows`` padded to ``max_batch`` with template rows
        and copy the batch to the device
        (:func:`~mca_tpu_torch.data.staging.to_device`: from pinned host
        blocks without blocking, once CUDA is initialised)."""
        assert 0 < len(rows) <= self.max_batch, len(rows)
        full = list(rows) + [self._template] * (self.max_batch - len(rows))
        return to_device(self.collate(full), self.device)

    def _dispatch(self, rows: Sequence[Dict[str, Any]], requests: Sequence[int] = ()):
        """Collate + copy + launch one chunk; returns the device tensors
        without waiting for them (CUDA launches are asynchronous).

        Recorded as a ``serve.batch`` span with the counts ``serve.rows``
        and ``serve.padded_rows``, its forward timed on a CUDA device; the
        ``requests`` (:meth:`Recorder.request` ids) it carries are stamped
        as dispatched in it."""
        with trace.span("serve.batch") as sp:
            trace.RECORDER.dispatched(requests, sp.seq)
            batch = self._pad(rows)
            trace.count("serve.rows", len(rows))
            trace.count("serve.padded_rows", self.max_batch - len(rows))
            with torch.inference_mode():
                sp.device_start(self.device)
                return self._fn(batch)

    @staticmethod
    def _materialise(dev, n: int):
        """The first ``n`` rows on the host (the copy waits for the
        forward), then the device times of the forwards that ended."""
        e, m = dev
        out = e[:, :n].cpu().numpy(), m[:, :n].cpu().numpy()
        trace.RECORDER.settle()
        return out

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
                _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("EmbeddingService stopped"))

    def submit(self, row: Dict[str, Any]) -> "Future":
        """Async single-row request, coalesced with concurrent requests
        into one forward by the batcher thread.  Its submission, dispatch
        and answer are stamped in :data:`mca_tpu_torch.utils.trace.RECORDER`'s
        request records."""
        assert self._batcher is not None, "call start() first"
        fut: Future = Future()
        self._queue.put((row, fut, trace.RECORDER.request()))
        return fut

    def _batch_loop(self) -> None:
        """Coalesce queued rows; batch N+1 is collated and launched
        while batch N still computes, and only then is N copied back."""
        inflight = None  # (pending list, device tensors)

        def resolve(pending, dev):
            try:
                e, m = self._materialise(dev, len(pending))
                trace.RECORDER.answered([rid for _, _, rid in pending])
                for i, (_, fut, _) in enumerate(pending):
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
                for _, fut, _ in pending:
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
                dev = self._dispatch([r for r, _, _ in pending], [rid for _, _, rid in pending])
            except Exception as e:  # pragma: no cover
                for _, fut, _ in pending:
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


def service_from_args(args) -> EmbeddingService:
    """The service the CLI's arguments ask for: from ``--aot``, or from
    the config with ``--restart`` / ``--allow-random-weights``."""
    if args.aot:
        if args.quantize != "none":
            raise ValueError(
                "--quantize applies when the model is built: quantise when "
                "exporting the artifact (tools.export_aot --quantize int8), "
                "not when serving it"
            )
        return EmbeddingService.from_aot(
            args.aot, max_wait_ms=args.max_wait_ms, device=args.device
        )
    from mca_tpu_torch.config import training_config

    if not args.config:
        raise SystemExit("pass a train yaml, or --aot <artifact>")
    config = training_config(args.config)
    restart = args.restart or (config.restart or None)
    if not (restart or args.allow_random_weights):
        raise SystemExit(
            "no checkpoint: pass --restart <dir>, or --allow-random-weights "
            "for a demo server"
        )
    return EmbeddingService(
        config,
        restart=restart,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        quantize=args.quantize,
        device=args.device,
        seed=args.seed,
    )


def parse_args(argv=None):
    import argparse
    import sys

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", nargs="?", default=None, help="train yaml (omit with --aot)")
    p.add_argument("--restart", default=None, help="checkpoint dir: a train state or a final model")
    p.add_argument(
        "--aot", default=None,
        help="serve a tools.export_aot artifact (no config or checkpoint)",
    )
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument(
        "--quantize", choices=QUANT_MODES, default="none",
        help="int8 weights for the block projections (ops.quant)",
    )
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--allow-random-weights",
        action="store_true",
        help="serve from random weights drawn from --seed (demo only)",
    )
    return p.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    svc = service_from_args(args)
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
