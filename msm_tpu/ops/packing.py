"""Dense-packed canonical coordinate rows — the point-table wire format.

A converted point table is stored as canonical Montgomery coordinates
bit-packed at radix 2^32 (``coord_words`` int32 words per coordinate: 8 for
BN254, 12 for BLS12-381), so the per-subtask sorted-order gather moves 64 B
per BN254 point instead of the 240 B of three [L] limb rows. Packing happens
once per MSM (or once per plan); the scan unpacks each gathered row with at
most two shifts and a mask per limb.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from msm_tpu.params import MsmConfig


def coord_words(cfg: MsmConfig) -> int:
    """int32 words per dense-packed canonical coordinate."""
    return (cfg.curve.modulus_bits + 31) // 32


def _pack_plan(w: int, L: int, D: int) -> list[list[tuple[int, int]]]:
    """Static bit plan: plan[k] lists (limb j, shift) whose
    ``limb_j << shift`` (``>> -shift`` when negative) contributes bits to
    dense word k. Limb bit-ranges are disjoint, so contributions OR."""
    plan: list[list[tuple[int, int]]] = [[] for _ in range(D)]
    for j in range(L):
        lo, hi = w * j, w * j + w
        for k in range(lo // 32, min((hi + 31) // 32, D)):
            plan[k].append((j, lo - 32 * k))
    return plan


def pack_coords(x: jax.Array, cfg: MsmConfig) -> jax.Array:
    """[..., L] balanced limbs -> [..., D] dense int32 words (canonical
    value at radix 2^32). Canonicalizes first (FieldCtx.canonical), so the
    packed fields are plain nonneg bit ranges."""
    from msm_tpu.ops.field import get_field_ctx

    w, L, D = cfg.word_size, cfg.num_words, coord_words(cfg)
    assert x.shape[-1] == L, (x.shape, L)
    c = get_field_ctx(cfg).canonical(x)
    words = []
    for contrib in _pack_plan(w, L, D):
        v = None
        for j, s in contrib:
            t = c[..., j] << s if s >= 0 else c[..., j] >> (-s)
            v = t if v is None else v | t
        words.append(v if v is not None else jnp.zeros_like(c[..., 0]))
    return jnp.stack(words, axis=-1)


def unpack_limb(word, next_word, j: int, cfg: MsmConfig):
    """Limb j of a packed coordinate from its (at most two) source words.
    ``word`` is dense word ``(w*j)//32``; ``next_word`` the one above it,
    or None past the top. Logical-shift semantics are recovered from int32
    arithmetic shifts by masking the sign-extension bits."""
    w = cfg.word_size
    s = (w * j) % 32
    v = word
    if s:
        v = (v >> s) & ((1 << (32 - s)) - 1)  # logical >>
    if s + w > 32 and next_word is not None:
        v = v | (next_word << (32 - s))
    return v & ((1 << w) - 1)


def unpack_coords(p: jax.Array, cfg: MsmConfig) -> jax.Array:
    """[..., D] dense canonical words -> [..., L] standard w-bit limbs."""
    w, L, D = cfg.word_size, cfg.num_words, coord_words(cfg)
    cols = []
    for j in range(L):
        k = (w * j) // 32
        if k >= D:
            cols.append(jnp.zeros_like(p[..., 0]))
            continue
        nxt = p[..., k + 1] if k + 1 < D else None
        cols.append(unpack_limb(p[..., k], nxt, j, cfg))
    return jnp.stack(cols, axis=-1)
