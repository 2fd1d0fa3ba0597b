"""Sort/scan-based bucket machinery — the replacement for the reference's
atomic sparse transpose + per-bucket CSC walks.

Reference stages replaced here:
- Stage-2 CSR->CSC transpose (``transpose.template.wgsl:32-75``, serial with
  atomics): a global ``lax.sort`` by bucket key produces the same
  grouped-by-bucket ordering deterministically.
- Stage-3 SMVP per-bucket segment walk (``smvp.template.wgsl:31-117``, one
  thread per bucket, dynamic-length loops): replaced by ONE blocked inclusive
  prefix scan of point-adds over the sorted array (fixed trip count, wide
  vector lanes) + prefix-difference extraction at bucket boundaries:
      bucket_b = prefix[end_b - 1] + neg(prefix[end_{b-1} - 1])
  Empty buckets come out as P + (-P) = identity *automatically* because the
  group law is complete — no masking needed.
- Stage-4 BPR running sums (``bpr.template.wgsl:40-132``): same two-phase
  (m, g) blocked reduction, with the per-thread serial loops mapped to a
  lane-parallel ``lax.scan`` and the ``m*s`` corrections folded into a
  suffix-scan identity (sum_t t*m_t = sum_j suffix_j) so the only scalar-mul
  left is a power-of-two shift (static doublings).

Work budget per subtask of n points: n adds (row scan) + ~2R adds (row-offset
scan) + ~3B adds (boundaries + reduction), vs the reference GPU's ~n + 2B —
i.e. asymptotically the same point-add count, arranged as wide SIMD batches
with an O(n/R + log R + Bl) sequential depth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from msm_tpu.ops.curve import CurveCtx, PointBatch, point_where
from msm_tpu.ops.packing import coord_words, unpack_coords


def gather_points(pts: PointBatch, idx: jax.Array) -> PointBatch:
    return PointBatch(pts.x[idx], pts.y[idx], pts.z[idx])


def _shift_in_identity(ec: CurveCtx, pts: PointBatch, s: jax.Array) -> PointBatch:
    """[m] batch shifted UP by a TRACED amount s along axis 0, identity-filled:
    out[i] = pts[i-s] for i >= s else identity. Fixed shapes (dynamic_slice on
    an identity-prefixed buffer), so loop bodies using it compile once."""
    m = pts.x.shape[0]
    ident = ec.identity((m,) + pts.x.shape[1:-1])

    def sl(pad, a):
        buf = jnp.concatenate([pad, a], axis=0)  # [2m, ...]
        start = (m - s,) + (0,) * (a.ndim - 1)
        return jax.lax.dynamic_slice(buf, start, a.shape)

    return PointBatch(sl(ident.x, pts.x), sl(ident.y, pts.y), sl(ident.z, pts.z))


def hillis_steele_prefix(
    ec: CurveCtx, pts: PointBatch, reverse: bool = False
) -> PointBatch:
    """Inclusive prefix (or suffix) point-sums along axis 0 via Hillis-Steele:
    log2(m) iterations of x += shift(x, 2^k) inside ONE fori_loop whose body
    compiles once (fixed shapes). O(m log m) adds — use for SMALL m; large
    arrays go through blocked_prefix_scan."""
    m = pts.x.shape[0]
    if m == 1:
        return pts
    if reverse:
        rev = PointBatch(pts.x[::-1], pts.y[::-1], pts.z[::-1])
        out = hillis_steele_prefix(ec, rev)
        return PointBatch(out.x[::-1], out.y[::-1], out.z[::-1])
    nlev = (m - 1).bit_length()

    def body(k, x):
        return ec.add(x, _shift_in_identity(ec, x, jnp.int32(1) << k))

    return jax.lax.fori_loop(0, nlev, body, pts)


def tree_reduce_points(ec: CurveCtx, pts: PointBatch) -> PointBatch:
    """Sum a [m, ...] batch of points along axis 0. Large flat batches
    first fold blockwise (m adds via one lax.scan over 4096 lanes) so the
    Hillis-Steele ladder only runs at 4096 — m*log(m) -> m + 4096*12
    adds, which keeps the window tail tractable at production bucket
    counts (32768 buckets: 491k -> 81k adds).
    Point addition is exact and associative, so any association yields
    the same group element."""
    m = pts.x.shape[0]
    LANES = 4096
    if pts.x.ndim == 2 and m > LANES and m % LANES == 0:
        C2 = m // LANES

        def arr(a):  # [m, L] -> [C2, LANES, L], lane r owns r::LANES
            return a.reshape(C2, LANES, a.shape[-1])

        xs = PointBatch(arr(pts.x), arr(pts.y), arr(pts.z))

        def step(acc, x_c):
            return ec.add(acc, x_c), None

        tot, _ = jax.lax.scan(step, ec.identity((LANES,)), xs)
        pts = tot
    out = hillis_steele_prefix(ec, pts)
    return PointBatch(out.x[-1], out.y[-1], out.z[-1])


def exclusive_prefix_points(ec: CurveCtx, pts: PointBatch) -> PointBatch:
    """Exclusive prefix point-sums along axis 0, work-efficient for large m:
    m <= 4096 uses Hillis-Steele directly; larger arrays run a blocked
    lax.scan over 4096 lanes first (adds ~2m work, single body compile)."""
    m = pts.x.shape[0]
    LANES = 4096
    if m <= LANES or m % LANES != 0:
        incl = hillis_steele_prefix(ec, pts)
        ident1 = ec.identity((1,) + pts.x.shape[1:-1])
        return PointBatch(
            jnp.concatenate([ident1.x, incl.x[:-1]]),
            jnp.concatenate([ident1.y, incl.y[:-1]]),
            jnp.concatenate([ident1.z, incl.z[:-1]]),
        )
    # two-level: R2=LANES rows x C2 columns, contiguous per row
    C2 = m // LANES
    row_prefix, offsets = blocked_prefix_scan(ec, pts, LANES)
    # full exclusive prefix at i = offsets[i//C2] + row_prefix[(i%C2)-1, i//C2]
    idx = jnp.arange(m, dtype=jnp.int32) - 1
    return prefix_at(ec, row_prefix, offsets, idx)


def blocked_prefix_scan(
    ec: CurveCtx, pts: PointBatch, num_rows: int
) -> tuple[PointBatch, PointBatch]:
    """Inclusive prefix point-sums of a [n] batch, blocked as R lanes x C
    steps (lane r owns contiguous positions [r*C, (r+1)*C)).

    Returns (row_prefix [C, R], row_offsets [R]) such that
        prefix(i) = row_offsets[i // C] + row_prefix[i % C, i // C].
    """
    n = pts.x.shape[0]
    R = num_rows
    assert n % R == 0, (n, R)
    C = n // R
    L = pts.x.shape[-1]

    def arrange(a):  # [n, L] -> [C, R, L]
        return a.reshape(R, C, L).swapaxes(0, 1)

    xs = PointBatch(arrange(pts.x), arrange(pts.y), arrange(pts.z))

    def step(acc, x_c):
        acc = ec.add(acc, x_c)
        return acc, acc

    row_totals, row_prefix = jax.lax.scan(step, ec.identity((R,)), xs)
    offsets = exclusive_prefix_points(ec, row_totals)
    return row_prefix, offsets


def prefix_at(
    ec: CurveCtx,
    row_prefix: PointBatch,
    offsets: PointBatch,
    idx: jax.Array,
) -> PointBatch:
    """Gather inclusive prefix values at positions ``idx`` (int32 [m]) from
    a blocked scan's ``row_prefix`` [C, R, L] and lane ``offsets`` [R]:
    prefix(i) = offsets[i // C] + row_prefix[i % C, i // C]; idx == -1
    yields the identity (empty prefix)."""
    C = row_prefix.x.shape[0]
    valid = idx >= 0
    i = jnp.maximum(idx, 0)
    r = i // C
    c = i % C
    rp = PointBatch(row_prefix.x[c, r], row_prefix.y[c, r], row_prefix.z[c, r])
    out = ec.add(gather_points(offsets, r), rp)
    return point_where(valid, out, ec.identity(idx.shape))


def bucket_accumulate(
    ec: CurveCtx,
    table: jax.Array,
    keys: jax.Array,
    num_buckets: int,
    num_rows: int,
    signs: jax.Array | None = None,
) -> PointBatch:
    """Per-bucket signed point sums for one subtask (cuZK stages 2+3).

    table: the packed point table (``common.prepare_points``); keys: int32
    [n] in [0, num_buckets); signs: optional bool [n] (True -> subtract the
    point). Returns buckets [num_buckets] with bucket_b = sum_{keys==b} ±P_i.
    """
    pe = bucket_boundary_prefix(
        ec, table, keys, num_buckets, num_rows, signs=signs
    )
    # previous bucket's end-prefix (identity for bucket 0)
    ident1 = ec.identity((1,))
    prev = PointBatch(
        jnp.concatenate([ident1.x, pe.x[:-1]]),
        jnp.concatenate([ident1.y, pe.y[:-1]]),
        jnp.concatenate([ident1.z, pe.z[:-1]]),
    )
    return ec.add(pe, ec.neg(prev))


def bucket_boundary_prefix(
    ec: CurveCtx,
    table: jax.Array,
    keys: jax.Array,
    num_buckets: int,
    num_rows: int,
    signs: jax.Array | None = None,
) -> PointBatch:
    """The sorted-prefix values at bucket end boundaries: pe[b] is the
    inclusive point-prefix over all elements with key <= b, so bucket_b =
    pe[b] - pe[b-1]. The production pipeline consumes pe directly via the
    telescoped reduction (window_sum_from_pe) and never materializes the
    bucket differences.

    ``table`` is the packed point table [rows, W]: W = 2D (x, y) or, under
    GLV, 3D (x, beta*x, y) with keys over 2*rows logical columns (columns
    >= rows are the phi copies)."""
    n = keys.shape[0]
    # the sign bit rides inside the sort payload, so one permutation
    # gather serves both the coordinates and the signs
    sbit = max((n - 1).bit_length(), 1)
    payload = jnp.arange(n, dtype=jnp.int32)
    if signs is not None:
        assert sbit + 1 < 32, n
        payload = payload | (signs.astype(jnp.int32) << sbit)
    # unstable sort: bucket sums are order-free within a key
    sorted_keys, pv = jax.lax.sort(
        (keys, payload), is_stable=False, num_keys=1
    )
    ends = bucket_ends(sorted_keys, num_buckets)
    perm, flags = _decode_payload_step_major(
        pv,
        sbit if signs is not None else None,
        num_rows,
        table_rows=table.shape[0] if ec.cfg.glv else None,
    )
    rows = table[perm]  # [n, W] — the ONLY per-subtask gather, step-major
    row_prefix, offsets = sorted_prefix_scan(ec, rows, flags, num_rows)
    return prefix_at(ec, row_prefix, offsets, ends - 1)


def _decode_payload_step_major(
    pv: jax.Array, sbit: int | None, R: int, table_rows: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """Transpose the sorted payload vector to step-major order (element
    (c, r) = sorted position r*C + c) and split it into the gather
    permutation and the flag row. Lane r owns the contiguous sorted range
    [r*C, (r+1)*C); transposing the payload VECTOR (not the gathered
    coordinate data) lets the gather land directly in scan order.

    ``table_rows`` (GLV): the packed table has table_rows physical rows
    but the stream indexes 2*table_rows logical columns (columns >= n are
    the phi copies). The phi bit moves from the index into BIT 1 of the
    returned flag row (bit 0 stays the bucket sign) and the returned
    permutation is the physical row."""
    n = pv.shape[0]
    pv2 = pv.reshape(R, n // R).swapaxes(0, 1).reshape(n)
    if sbit is not None:
        idx = pv2 & ((1 << sbit) - 1)
        sg = pv2 >> sbit
    else:
        idx = pv2
        sg = jnp.zeros((n,), jnp.int32)
    if table_rows is not None:
        assert table_rows & (table_rows - 1) == 0, table_rows
        sg = sg | ((idx // table_rows) << 1)
        idx = idx % table_rows
    return idx, sg


def affine_from_rows(cfg, rows: jax.Array, flags: jax.Array):
    """Packed table rows [..., W] + flag words [...] -> signed affine
    Montgomery limbs (x, y), each [..., L]: bit 0 of a flag negates y (the
    signed-bucket sign), bit 1 selects the beta*x column of GLV rows."""
    D = coord_words(cfg)
    if cfg.glv:
        phi = ((flags >> 1) & 1) != 0
        xd = jnp.where(phi[..., None], rows[..., D : 2 * D], rows[..., :D])
        yd = rows[..., 2 * D :]
    else:
        xd, yd = rows[..., :D], rows[..., D:]
    x = unpack_coords(xd, cfg)
    y = unpack_coords(yd, cfg)
    return x, jnp.where(((flags & 1) != 0)[..., None], -y, y)


def sorted_prefix_scan(
    ec: CurveCtx, rows: jax.Array, flags: jax.Array, num_rows: int
) -> tuple[PointBatch, PointBatch]:
    """Blocked inclusive prefix scan of the gathered, sorted, signed affine
    points: R lanes x C = n/R mixed-add steps (lane r owns the sorted range
    [r*C, (r+1)*C)); ``rows``/``flags`` arrive step-major (element (c, r)
    first-axis-flat at c*R + r). Returns (row_prefix [C, R, L], exclusive
    lane offsets [R]) for ``prefix_at``."""
    n, W = rows.shape
    R = num_rows
    assert n % R == 0, (n, R)
    C = n // R

    def step(acc, xs):
        r, f = xs
        x2, y2 = affine_from_rows(ec.cfg, r, f)
        acc = ec.add_affine(acc, x2, y2)
        return acc, acc

    totals, row_prefix = jax.lax.scan(
        step,
        ec.identity((R,)),
        (rows.reshape(C, R, W), flags.reshape(C, R)),
    )
    return row_prefix, exclusive_prefix_points(ec, totals)


def window_sum_from_pe(ec: CurveCtx, pe: PointBatch) -> PointBatch:
    """W = sum_b b * S_b computed straight from the boundary prefixes by the
    telescoping identity

        sum_b b*(pe_b - pe_{b-1}) = (B-1)*pe_{B-1} - sum_{b<B-1} pe_b

    which replaces the entire two-phase BPR running-sum machinery (cuZK
    Alg. 4, the reference's ``bpr.template.wgsl``) with ONE point-sum
    reduction plus log2(B-1) doublings (B-1 = 2^(c-1) is a power of two):
    ~1 add per bucket instead of ~3. bucket_reduce_blocked remains as the
    reference-shaped parity implementation."""
    B = pe.x.shape[0]
    assert (B - 1) & (B - 2) == 0, f"B-1 = {B - 1} must be a power of two"
    body = PointBatch(pe.x[:-1], pe.y[:-1], pe.z[:-1])
    total = tree_reduce_points(ec, body)
    last = PointBatch(pe.x[-1], pe.y[-1], pe.z[-1])
    last = jax.lax.fori_loop(  # * (B-1), a power of two
        0, (B - 1).bit_length() - 1, lambda _, a: ec.double(a), last
    )
    return ec.add(last, ec.neg(total))


def bucket_ends(sorted_keys: jax.Array, num_buckets: int) -> jax.Array:
    """ends[b] = #{i : keys[i] <= b}, by binary search of every bucket
    index in the already-sorted keys (exact integer counts)."""
    q = jnp.arange(num_buckets, dtype=sorted_keys.dtype)
    return jnp.searchsorted(sorted_keys, q, side="right").astype(jnp.int32)


def bucket_reduce_running(ec: CurveCtx, buckets: PointBatch) -> PointBatch:
    """W = sum_b b * S_b by the descending running-sum identity, scanning the
    bucket axis (axis 0, multiplier == index) serially — the analogue of
    running_sum_bucket_reduction (reference test/utils.rs:238-251). Batched
    over any trailing batch axes. Use for SMALL bucket counts."""
    B = buckets.x.shape[0]
    batch = buckets.x.shape[1:-1]

    def arrange(a):  # descending multipliers B-1 .. 1 (skip bucket 0)
        return a[1:][::-1]

    xs = PointBatch(arrange(buckets.x), arrange(buckets.y), arrange(buckets.z))

    def step(carry, s_b):
        running, acc = carry
        running = ec.add(running, s_b)
        acc = ec.add(acc, running)
        return (running, acc), None

    (_, acc), _ = jax.lax.scan(
        step, (ec.identity(batch), ec.identity(batch)), xs
    )
    return acc


def bucket_reduce_blocked(
    ec: CurveCtx, buckets: PointBatch, num_threads: int
) -> PointBatch:
    """W = sum_b b * S_b via the two-phase blocked reduction (cuZK Alg.4 /
    reference bpr.template.wgsl:40-132), lane-parallel over T threads.

    Phase 1: thread t descends its block of Bl buckets accumulating
    (m_t = block sum, g_t = sum of running sums).
    Phase 2: W = sum_t g_t + Bl * sum_t t*m_t, where sum_t t*m_t is computed
    by the suffix-scan identity (no per-thread scalar-mul; the reference uses
    double_and_add at bpr.template.wgsl:124-126) and Bl is a power of two so
    the final scalar-mul is log2(Bl) doublings.
    """
    B = buckets.x.shape[0]
    body_len = B - 1
    T = num_threads
    assert body_len % T == 0, (body_len, T)
    Bl = body_len // T
    assert Bl & (Bl - 1) == 0, f"block size {Bl} must be a power of two"
    L = buckets.x.shape[-1]

    def arrange(a):  # steps-major, descending in-block
        return a[1:].reshape(T, Bl, L).swapaxes(0, 1)[::-1]

    xs = PointBatch(
        arrange(buckets.x), arrange(buckets.y), arrange(buckets.z)
    )

    def step(carry, s):
        mm, gg = carry
        mm = ec.add(mm, s)
        gg = ec.add(gg, mm)
        return (mm, gg), None

    (m, g), _ = jax.lax.scan(
        step, (ec.identity((T,)), ec.identity((T,))), xs
    )
    total_g = tree_reduce_points(ec, g)
    # sum_t t*m_t = sum_j suffix_j - suffix_0 (suffix_j = sum_{t>=j} m_t):
    # one reverse Hillis-Steele + one reduce — no per-thread scalar-mul
    # (the reference's double_and_add at bpr.template.wgsl:124-126)
    suff = hillis_steele_prefix(ec, m, reverse=True)
    suff_total = tree_reduce_points(ec, suff)
    s0 = PointBatch(suff.x[0], suff.y[0], suff.z[0])
    corr = ec.add(suff_total, ec.neg(s0))
    for _ in range(Bl.bit_length() - 1):  # * Bl (power of two)
        corr = ec.double(corr)
    return ec.add(total_g, corr)
