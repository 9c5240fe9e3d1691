"""Checkpoints and the final model, ported from ``mca_tpu/checkpoint.py``.

The JAX package's directory layout, with torch files in place of
orbax's:

- ``<dir>/state/state.pt``: a train state, ``{"model": state_dict,
  "optimizer": state_dict, "schedule": state_dict, "step": int,
  "epoch": int}``; ``<dir>`` is ``output_dir/<epoch>`` at the end of
  an epoch, ``output_dir`` for ``n_step_checkpoint`` and preemption,
  ``output_dir/diverged`` for the forensic save;
- ``<dir>/model/model.pt``: the final parameters (a state dict);
- ``model.safetensors``: the same parameters in the reference's
  ``save_model`` format, written by :func:`export_safetensors` and read
  by :func:`read_safetensors` (no ``safetensors`` package needed).

State dicts carry the torch reference's key names, which are the
port's module names.  Every file is written to a temporary name and
renamed, so a reader never sees half a checkpoint.  A run on several
ranks gathers the whole state first (tensor-parallel leaves over
``model``, FSDP shards and moments over ``data``:
:class:`mca_tpu_torch.parallel.sharding.ShardedOptimizer`) and rank 0
writes it, in this same format, so a checkpoint restarts, serves and
infers at any world size.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any, Dict, Mapping, Optional

import torch

STATE = "state"
MODEL = "model"


def _path(directory: str, kind: str) -> str:
    return os.path.join(os.path.abspath(directory), kind, f"{kind}.pt")


def _atomic_save(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpointer:
    """Writes train states, synchronously or on a background thread.

    A save first copies every tensor of the state into host buffers
    that are allocated at the first save and reused by every later one
    (pinned for CUDA tensors), so a run holds one host copy of its state
    however many checkpoints it writes; an asynchronous save then writes
    the file on a thread while training goes on.  A save waits for the
    previous write before it refills the buffers; call
    :meth:`wait_for_saves` before reading a checkpoint back, pruning
    checkpoint directories, or exiting.
    """

    def __init__(self):
        self._buffers: Dict[str, torch.Tensor] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: list = []

    def _to_host(self, obj: Any, key: str = "") -> Any:
        if isinstance(obj, torch.Tensor):
            buf = self._buffers.get(key)
            if buf is None or buf.shape != obj.shape or buf.dtype != obj.dtype:
                buf = torch.empty(
                    obj.shape, dtype=obj.dtype, pin_memory=obj.is_cuda
                )
                self._buffers[key] = buf
            buf.copy_(obj.detach(), non_blocking=obj.is_cuda)
            return buf
        if isinstance(obj, Mapping):
            return {k: self._to_host(v, f"{key}/{k}") for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._to_host(v, f"{key}/{i}") for i, v in enumerate(obj))
        return obj

    def _write(self, host: Any, path: str) -> None:
        try:
            _atomic_save(host, path)
        except BaseException as e:  # noqa: BLE001 - raised by wait_for_saves
            self._error.append(e)

    def save_state(self, state: Mapping[str, Any], directory: str, *,
                   asynchronous: bool = False) -> None:
        """Save ``state`` under ``directory/state``.  The copy to the
        host ends before this returns, so training may change the state
        at once; with ``asynchronous`` the file is written on a thread."""
        self.wait_for_saves()
        host = self._to_host(state)
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the non-blocking copies have landed
        path = _path(directory, STATE)
        if asynchronous:
            self._thread = threading.Thread(target=self._write, args=(host, path))
            self._thread.start()
        else:
            self._write(host, path)
            self.wait_for_saves()

    def wait_for_saves(self) -> None:
        """Block until the last write has finished; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()


def load_state(directory: str) -> Dict[str, Any]:
    """The train state saved under ``directory/state``, on the CPU."""
    return torch.load(_path(directory, STATE), map_location="cpu", weights_only=True)


def save_params(state_dict: Mapping[str, torch.Tensor], directory: str) -> None:
    """The final parameters under ``directory/model``."""
    _atomic_save(
        {k: v.detach().cpu() for k, v in state_dict.items()}, _path(directory, MODEL)
    )


def load_params(directory: str) -> Dict[str, torch.Tensor]:
    """Parameters from a train-state directory (``directory/state``) or
    a final-model directory (``directory/model``), as
    ``mca_tpu.infer._restore_params`` accepts either."""
    if os.path.exists(_path(directory, STATE)):
        return load_state(directory)["model"]
    if os.path.exists(_path(directory, MODEL)):
        return torch.load(_path(directory, MODEL), map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"{directory} holds neither {STATE}/{STATE}.pt nor {MODEL}/{MODEL}.pt"
    )


_SAFETENSORS_DTYPES = {
    torch.float64: "F64",
    torch.float32: "F32",
    torch.float16: "F16",
    torch.bfloat16: "BF16",
    torch.int64: "I64",
    torch.int32: "I32",
    torch.int16: "I16",
    torch.int8: "I8",
    torch.uint8: "U8",
    torch.bool: "BOOL",
}


def export_safetensors(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``state_dict`` as a safetensors file: the header's length
    as 8 little-endian bytes, the JSON header (``{key: {"dtype",
    "shape", "data_offsets"}}`` and ``__metadata__``, padded with spaces
    to 8 bytes), then each tensor's raw bytes in key order (little-endian,
    the byte order of the hosts this runs on)."""
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for key in sorted(state_dict):
        t = state_dict[key].detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[key] = {
            "dtype": _SAFETENSORS_DTYPES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)
    os.replace(tmp, path)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors file's tensors, on the CPU: the header's length (8
    little-endian bytes), the JSON header, then the raw bytes each entry's
    ``data_offsets`` name (what :func:`export_safetensors` writes, and the
    reference's ``save_model``)."""
    dtypes = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        data = f.read()
    header.pop("__metadata__", None)
    out = {}
    for key, h in header.items():
        lo, hi = h["data_offsets"]
        raw = bytearray(data[lo:hi])
        t = torch.frombuffer(raw, dtype=torch.uint8) if raw else torch.empty(0, dtype=torch.uint8)
        out[key] = t.view(dtypes[h["dtype"]]).reshape(h["shape"])
    return out
