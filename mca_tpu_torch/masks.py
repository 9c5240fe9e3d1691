"""Static attention / pooling mask constructors for the MCA family.

The port's own copy of ``mca_tpu/masks.py`` (pure numpy, kept
verbatim so both packages build identical masks; a test pins that).

Pure numpy functions of the token-type layout — built once at model
construction and baked into the jit-compiled program as constants.
Convention matches the reference: **True = attention blocked**.

Semantics re-derived from the reference implementation:

- token types: ``create_token_types_tensor`` (ref model.py:383-390) —
  the packed sequence is ``[0]*T0 + [1]*T1 + ... + [-1]*num_fusion``.
- Zorro mask (ref model.py:392-398): token i may attend j iff they share
  a modality, or i is a fusion token (fusion attends everywhere).
- MCA mask (ref model.py:408-430): the fusion rows are re-written into
  ``len(fusion_combos)`` channels of ``num_fusion/len(combos)`` tokens
  each; channel c attends only to its combo's modality tokens plus its
  own channel's fusion tokens.
- Zorro pooling mask (ref model.py:400-406): return token r attends only
  tokens of its own type; the global return token (type -2) attends all.
- MCA pooling mask (ref model.py:432-446): the fusion return rows are
  block-diagonalised so fusion-return c attends only channel c's fusion
  tokens.

These masks are block-structured; :func:`block_mask_info` extracts the
per-tile block map the Pallas flash-attention kernel uses to skip work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import chain, combinations
from typing import FrozenSet, List, Sequence, Tuple

import numpy as np

FUSION_TOKEN = -1
GLOBAL_TOKEN = -2


def adjusted_powerset(
    items: Sequence[int], powers: Sequence[int]
) -> List[FrozenSet[int]]:
    """All size-r combinations of ``items`` for each r in ``powers``.

    Order matters: the reference (model.py:11-12) yields combos grouped by
    the order of ``powers`` and lexicographically within each size; the
    first combo is the FCL root when ``powers[0] == len(items)``.
    """
    return [
        frozenset(c)
        for c in chain.from_iterable(
            combinations(items, r) for r in powers
        )
    ]


def create_token_types(
    token_dims: Sequence[int], num_fusion_tokens: int
) -> np.ndarray:
    """Packed token-type vector, e.g. ``[0,0,0,1,1,2,-1,-1]``."""
    parts = [np.full(n, i, dtype=np.int64) for i, n in enumerate(token_dims)]
    parts.append(np.full(num_fusion_tokens, FUSION_TOKEN, dtype=np.int64))
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def create_zorro_mask(
    token_types: np.ndarray, no_fusion: bool = False
) -> np.ndarray:
    """[T, T] bool, True = blocked (ref model.py:392-398)."""
    tt_from = token_types[:, None]
    tt_to = token_types[None, :]
    allowed = tt_from == tt_to
    if not no_fusion:
        allowed = allowed | (tt_from == FUSION_TOKEN)
    return ~allowed


def create_mca_mask(
    token_types: np.ndarray,
    fusion_combos: Sequence[FrozenSet[int]],
    zorro_mask: np.ndarray,
) -> np.ndarray:
    """Rewrite the fusion rows of the Zorro mask into per-combo channels.

    Ref model.py:408-430.  ``num_fusion_tokens`` must divide evenly by
    ``len(fusion_combos)``; channel c owns the c-th contiguous chunk of
    fusion tokens, attends its combo's modality tokens and its own chunk.
    """
    mask = zorro_mask.copy()
    fusion_positions = np.nonzero(token_types == FUSION_TOKEN)[0]
    num_fusion = len(fusion_positions)
    if num_fusion == 0:
        return mask
    n_combos = len(fusion_combos)
    assert num_fusion % n_combos == 0, (
        f"Number of fusion tokens {num_fusion} must be divisible by the "
        f"number of combinations {n_combos}"
    )
    nsubtok = num_fusion // n_combos
    for c, combo in enumerate(fusion_combos):
        row = ~np.isin(token_types, list(combo))  # blocked outside combo
        row[fusion_positions] = True  # block all fusion tokens ...
        own = fusion_positions[c * nsubtok : (c + 1) * nsubtok]
        row[own] = False  # ... except the channel's own chunk
        mask[own, :] = row[None, :]
    return mask


def create_zorro_pooling_mask(
    token_types: np.ndarray, return_token_types: np.ndarray
) -> np.ndarray:
    """[R, T] bool, True = blocked (ref model.py:400-406)."""
    rt = np.asarray(return_token_types)[:, None]
    tt = token_types[None, :]
    allowed = (rt == tt) | (rt == GLOBAL_TOKEN)
    return ~allowed


def create_mca_pooling_mask(
    token_types: np.ndarray,
    fusion_combos: Sequence[FrozenSet[int]],
    return_token_types: np.ndarray,
    pool_mask: np.ndarray,
) -> np.ndarray:
    """Block-diagonalise fusion return rows per channel (ref model.py:432-446)."""
    mask = pool_mask.copy()
    rt = np.asarray(return_token_types)
    fusion_rows = np.nonzero(rt == FUSION_TOKEN)[0]
    fusion_cols = np.nonzero(token_types == FUSION_TOKEN)[0]
    num_fusion = len(fusion_cols)
    n_combos = len(fusion_combos)
    if num_fusion == 0 or len(fusion_rows) == 0:
        return mask
    assert num_fusion % n_combos == 0
    assert len(fusion_rows) == n_combos, (
        f"{len(fusion_rows)} fusion return tokens != {n_combos} combos"
    )
    nsubtok = num_fusion // n_combos
    for c in range(n_combos):
        own = fusion_cols[c * nsubtok : (c + 1) * nsubtok]
        mask[fusion_rows[c], fusion_cols] = True
        mask[fusion_rows[c], own] = False
    return mask


def make_return_token_types(
    n_modalities: int,
    n_combos: int,
    *,
    no_fusion: bool,
    fcl: bool,
    zorro: bool,
) -> List[int]:
    """Return-token layout (ref model.py:313-326).

    - ``no_fusion``: one per modality + global.
    - plain fusion / zorro / no FCL: modalities + one fusion + global.
    - FCL: modalities + one fusion per combo + global.
    """
    mods = list(range(n_modalities))
    if no_fusion:
        return mods + [GLOBAL_TOKEN]
    if not fcl or zorro:
        return mods + [FUSION_TOKEN, GLOBAL_TOKEN]
    return mods + [FUSION_TOKEN] * n_combos + [GLOBAL_TOKEN]


def pooling_token_type_order(token_types: np.ndarray) -> List[int]:
    """Unique token types in mean-pooling output order (ref model.py:242-247).

    Non-negative types ascending, then negative types descending
    (modalities first, fusion/global at the tail).
    """
    u = sorted(set(int(t) for t in token_types))
    return [t for t in u if t >= 0] + sorted(
        [t for t in u if t < 0], reverse=True
    )


@dataclass(frozen=True)
class MaskSet:
    """All static masks + layout metadata for one model configuration."""

    token_types: np.ndarray
    return_token_types: np.ndarray
    attn_mask: np.ndarray  # [T, T] bool, True = blocked
    pool_mask: np.ndarray  # [R, T] bool, True = blocked
    fusion_combos: Tuple[FrozenSet[int], ...] = field(default=())
    num_fusion_tokens: int = 0

    @property
    def seq_len(self) -> int:
        return int(self.token_types.shape[0])

    @property
    def num_return_tokens(self) -> int:
        return int(self.return_token_types.shape[0])


def build_masks(
    token_dims: Sequence[int],
    num_fusion_tokens: int,
    fusion_combos_powers: Sequence[int],
    *,
    zorro: bool = False,
    fcl: bool = True,
    no_fusion: bool = False,
) -> MaskSet:
    """Build the full mask set for an MCA/MMA configuration.

    Mirrors the constructor wiring in ref model.py:312-372: Zorro mask
    always; MCA fusion-channel rewrite unless ``zorro``; pooling-mask
    block-diagonalisation only when ``fcl`` (and not ``zorro``).
    """
    n_mod = len(token_dims)
    combos = adjusted_powerset(list(range(n_mod)), fusion_combos_powers)
    if no_fusion:
        num_fusion_tokens = 0
    token_types = create_token_types(token_dims, num_fusion_tokens)
    return_tt = np.asarray(
        make_return_token_types(
            n_mod, len(combos), no_fusion=no_fusion, fcl=fcl, zorro=zorro
        ),
        dtype=np.int64,
    )
    attn = create_zorro_mask(token_types, no_fusion=no_fusion)
    pool = create_zorro_pooling_mask(token_types, return_tt)
    if not zorro:
        attn = create_mca_mask(token_types, combos, attn)
        if fcl and not no_fusion:
            pool = create_mca_pooling_mask(
                token_types, combos, return_tt, pool
            )
    return MaskSet(
        token_types=token_types,
        return_token_types=return_tt,
        attn_mask=attn,
        pool_mask=pool,
        fusion_combos=tuple(combos),
        num_fusion_tokens=num_fusion_tokens,
    )


def block_mask_info(
    attn_mask: np.ndarray, block_q: int, block_k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tile-level sparsity map of a static [T, T] mask for Pallas.

    Pads T up to multiples of the block sizes (padded positions are
    blocked) and returns, per query block:

    - ``kv_index`` [num_q_blocks, max_active]: the active kv-block ids,
      compacted to the front (padded with 0),
    - ``kv_count`` [num_q_blocks]: how many entries are active,
    - ``block_full`` [num_q_blocks, max_active]: 1 where the tile has no
      blocked entries at all (mask application can be skipped inside).
    """
    t = attn_mask.shape[0]
    tq = -(-t // block_q) * block_q
    tk = -(-t // block_k) * block_k
    padded = np.ones((tq, tk), dtype=bool)
    padded[:t, :t] = attn_mask
    nq, nk = tq // block_q, tk // block_k
    tiles = padded.reshape(nq, block_q, nk, block_k)
    any_allowed = ~tiles.all(axis=(1, 3))  # [nq, nk]
    all_allowed = ~tiles.any(axis=(1, 3))
    counts = any_allowed.sum(axis=1)
    max_active = int(counts.max()) if counts.size else 0
    kv_index = np.zeros((nq, max(max_active, 1)), dtype=np.int32)
    block_full = np.zeros((nq, max(max_active, 1)), dtype=np.int32)
    for i in range(nq):
        active = np.nonzero(any_allowed[i])[0]
        kv_index[i, : len(active)] = active
        block_full[i, : len(active)] = all_allowed[i, active]
    return kv_index, counts.astype(np.int32), block_full
