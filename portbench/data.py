"""Rows and weights made from a run's seed.

Rows have the shapes of the program's synthetic TCGA and CMU-MOSEI
rows: every modality observes a per-row latent through its own random
map plus noise, and each modality is missing with probability
``p_missing``.  A ``sequence`` modality (TCGA) is a ``values`` vector of
``pad_len`` floats, all ``pad_token`` when missing; an
``embedded_sequence`` modality (CMU-MOSEI) is a ``[t, width]`` matrix,
``t`` drawn from 1 to ``pad_len``, or ``None`` when missing.

Weights are made on the device in two draws (one normal, one uniform)
and cut into the leaves that :func:`portbench.reference.model.param_specs`
lists, so the program and the reference get the same values.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.model import LOGIT_INIT, param_specs

LATENT = 8


def seed_words(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator from the run's seed (any whole number) and salts."""
    return np.random.default_rng([int(seed) % 2**63, *salt])


def make_rows(cfg: dict, n: int, seed: int, p_missing: float, salt: int = 0) -> List[dict]:
    """``n`` rows for ``cfg``'s modalities."""
    rng = seed_words(seed, 1, salt)
    mods = cfg["modality_config"]
    z = rng.standard_normal((n, LATENT), dtype=np.float32)
    missing = rng.random((n, len(mods))) < p_missing
    rows: List[dict] = [{} for _ in range(n)]
    for j, (m, mc) in enumerate(mods.items()):
        col = mc["data_col_name"]
        pad_len = int(mc["pad_len"])
        if mc["type"] == "sequence":
            w = rng.standard_normal((LATENT, pad_len), dtype=np.float32)
            vals = z @ w + 0.1 * rng.standard_normal((n, pad_len), dtype=np.float32)
            vals[missing[:, j]] = float(mc["pad_token"])
            for i in range(n):
                rows[i][m] = {col: vals[i]}
        elif mc["type"] == "embedded_sequence":
            width = int(mc["embedding_size"])
            w = rng.standard_normal((LATENT, width), dtype=np.float32)
            lens = rng.integers(1, pad_len + 1, size=n)
            for i in range(n):
                if missing[i, j]:
                    rows[i][m] = {col: None}
                    continue
                t = int(lens[i])
                seq = z[i] @ w + 0.1 * rng.standard_normal((t, width), dtype=np.float32)
                rows[i][m] = {col: seq}
        else:
            raise ValueError(f"no rows for modality type {mc['type']!r}")
    return rows


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, made on ``device`` from ``seed``: token tables and
    fusion / return tokens standard normal, matrices uniform within
    ``1/sqrt(fan_in)``, norm scales 1, biases 0, the temperature
    log(1/0.07)."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    sizes = {name: int(np.prod(shape)) for name, shape, _ in specs}
    n_normal = sum(sizes[n] for n, _, init in specs if init == "normal")
    n_uniform = sum(sizes[n] for n, _, init in specs if init == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2).sub_(1)
    out, i_n, i_u = {}, 0, 0
    for name, shape, init in specs:
        k = sizes[name]
        if init == "normal":
            t = normal[i_n:i_n + k]
            i_n += k
        elif init == "uniform":
            t = uniform[i_u:i_u + k] * shape[-1] ** -0.5
            i_u += k
        elif init == "ones":
            t = torch.ones(k, device=device)
        elif init == "zeros":
            t = torch.zeros(k, device=device)
        else:
            t = torch.full((k,), LOGIT_INIT, device=device)
        out[name] = t.view(shape)
    return out
