"""Measurement tools.  :func:`host_description` names the host beside
every wall-clock figure they print: a step that waits on the host runs
as fast as the host it lands on."""

from __future__ import annotations

import os
import platform
import time

import torch


def host_probe_ms(n: int = 1_000_000) -> float:
    """Milliseconds of a fixed single-threaded Python loop: how fast the
    interpreter runs on this host right now, which bounds the launch
    rate of a host-bound step."""
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return (time.perf_counter() - t0) * 1e3


def host_description() -> str:
    """CPU (``/proc/cpuinfo`` where it names one), cores (all / usable
    by this process), torch's intra-op threads, the load averages and
    :func:`host_probe_ms`, as one line."""
    info = {}
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    cpu = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model") if k in info
    ) or platform.processor() or platform.machine()
    if "cpu MHz" in info:
        cpu += f" at {info['cpu MHz']} MHz"
    usable = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else "?"
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return (
        f"host: {cpu}, {os.cpu_count()} cores ({usable} usable), torch threads "
        f"{torch.get_num_threads()}, load average {load}, Python loop probe "
        f"{host_probe_ms():.1f} ms"
    )


def request_rows(config, n: int, seed: int = 1) -> list:
    """``n`` request rows for the config's modalities, without labels:
    :func:`mca_tpu_torch.data.synthetic.tabular_rows` for tabular
    configs, else :func:`mca_tpu_torch.train.synthetic_rows`'s
    (CMU-MOSEI-shaped) rows."""
    from mca_tpu_torch.data.synthetic import tabular_rows
    from mca_tpu_torch.train import plain, synthetic_rows

    mods = plain(config.modality_config)
    if {c["type"] for c in mods.values()} == {"sequence"}:
        return tabular_rows(mods, n, seed=seed)
    return [{m: r[m] for m in mods} for r in synthetic_rows(config, n, seed=seed)]


def median_host_ms(fn, sync, repeats: int = 5) -> float:
    """Median wall ms of ``repeats`` calls of ``fn``, each between two
    calls of ``sync`` (``torch.cuda.synchronize`` for device work)."""
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def host_batch_costs(config, rows: list, device, stage_dtypes=("fp32", "bf16"),
                     repeats: int = 5) -> dict:
    """The host's side of one batch of ``rows``, median ms of ``repeats``:
    ``collate_ms`` (``MultimodalCollator``), and for each of
    ``stage_dtypes`` ``narrow_ms`` (:func:`train.narrow_for_staging`),
    ``copy_ms`` (:func:`train.to_device`, host to device and the upcast,
    synchronised) and ``bytes`` copied."""
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.train import narrow_for_staging, plain, staging_sentinels, to_device

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def median_ms(fn) -> float:
        return median_host_ms(fn, sync, repeats)

    collate = MultimodalCollator(plain(config.modality_config))
    out = {"collate_ms": median_ms(lambda: collate(rows))}
    batch = collate(rows)
    sentinels = staging_sentinels(config)
    for sd in stage_dtypes:
        staged = narrow_for_staging(batch, sd, sentinels)
        n_bytes = sum(torch.as_tensor(v).nbytes for f in staged.values() for v in f.values())
        out[sd] = {
            "narrow_ms": median_ms(lambda: narrow_for_staging(batch, sd, sentinels)),
            "copy_ms": median_ms(lambda: to_device(staged, dev)),
            "bytes": int(n_bytes),
        }
    return out


def sample_tokens(config, model) -> int:
    """Tokens one sample puts through the blocks: the packed sequence of
    an MCA model, the sum of an EAO model's pass lengths."""
    if not config.get("eao", False):
        return int(model.mask_set.seq_len)
    mods = config.modality_config
    mods = mods.to_plain() if hasattr(mods, "to_plain") else dict(mods)
    lens = [int(mods[m]["pad_len"]) for m in model.modality_types]
    return sum(sum(lens[i] for i in ch) for ch in model.channels)
