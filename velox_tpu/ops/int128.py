"""128-bit integer arithmetic over (hi, lo) int64 limb pairs.

Reference: velox/type/HugeInt.h + DecimalUtil.h — the reference backs
DECIMAL(p>18) with a native __int128.  XLA has no 128-bit integer type, so
a hugeint value v is represented as two int64 columns with
``v = hi * 2**64 + uint64(lo)`` — hi carries the sign, lo is the raw low
word.  Every op here is a branch-free elementwise jnp expression (fully
fusable); numpy twins with identical bit semantics drive the
host-side oracles and the host halves of the engine.

The device functions are registered into the scalar function registry under
``__i128_*`` names; exec/hugeint.py lowers long-decimal expressions onto
them as a plan rewrite — the same strategy as the HLL sketch lowering.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# numpy twins (host side; wrap-safe)


def np_from_int(values) -> Tuple[np.ndarray, np.ndarray]:
    """Python ints / int64 array -> (hi, lo) limbs."""
    if isinstance(values, np.ndarray) and values.dtype == np.int64:
        return values >> 63, values.copy()
    out_hi = np.empty(len(values), np.int64)
    out_lo = np.empty(len(values), np.int64)
    for i, v in enumerate(values):
        v = int(v)
        out_lo[i] = np.int64((v & ((1 << 64) - 1)) - (1 << 64)) if (
            v & (1 << 63)
        ) else np.int64(v & ((1 << 64) - 1))
        out_hi[i] = np.int64(v >> 64)
    return out_hi, out_lo


def np_to_int(hi: np.ndarray, lo: np.ndarray):
    """(hi, lo) limbs -> python ints (exact)."""
    return [
        (int(h) << 64) + (int(l) & ((1 << 64) - 1))
        for h, l in zip(np.asarray(hi), np.asarray(lo))
    ]


def np_add(ah, al, bh, bl):
    with np.errstate(over="ignore"):
        lo = (al.astype(np.uint64) + bl.astype(np.uint64)).astype(np.int64)
        carry = lo.astype(np.uint64) < al.astype(np.uint64)
        hi = ah + bh + carry.astype(np.int64)
    return hi, lo


def np_neg(hi, lo):
    with np.errstate(over="ignore"):
        nlo = (-lo.astype(np.uint64)).astype(np.int64)
        nhi = ~hi + (lo == 0).astype(np.int64)
    return nhi, nlo


def np_mul_i64(a, b):
    """Exact int64 x int64 -> (hi, lo) via 32-bit partial products."""
    with np.errstate(over="ignore"):
        au = a.astype(np.uint64)
        bu = b.astype(np.uint64)
        a0, a1 = au & np.uint64(_MASK32), au >> np.uint64(32)
        b0, b1 = bu & np.uint64(_MASK32), bu >> np.uint64(32)
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        mid = (p00 >> np.uint64(32)) + (p01 & np.uint64(_MASK32)) + (
            p10 & np.uint64(_MASK32)
        )
        lo = ((mid & np.uint64(_MASK32)) << np.uint64(32)) | (
            p00 & np.uint64(_MASK32)
        )
        hi_u = p11 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32)) + (
            mid >> np.uint64(32)
        )
        # unsigned -> signed correction: subtract (b if a<0) and (a if b<0)
        hi = hi_u.astype(np.int64)
        hi = hi - np.where(a < 0, b, 0) - np.where(b < 0, a, 0)
    return hi, lo.astype(np.int64)


def np_mul(ah, al, bh, bl):
    """Truncated (mod 2**128) product of two limb pairs — the semantics of
    the reference's __int128 multiply (DecimalUtil.h); overflow past 128 bits
    wraps (the lowering adds explicit guards where the reference throws)."""
    vals_a = np_to_int(np.asarray(ah), np.asarray(al))
    vals_b = np_to_int(np.asarray(bh), np.asarray(bl))
    prods = [
        ((a * b) + (1 << 128)) % (1 << 129) - (1 << 128)
        if ((a * b) % (1 << 128)) >> 127
        else (a * b) % (1 << 128)
        for a, b in zip(vals_a, vals_b)
    ]
    return np_from_int(prods)


def np_div_round(a_ints, b_ints):
    """Round-half-away-from-zero integer division (python ints, exact) — the
    oracle twin of __i128_div_* (reference: DecimalUtil::divideWithRoundUp)."""
    out = []
    for a, b in zip(a_ints, b_ints):
        q, r = divmod(abs(int(a)), abs(int(b)))
        if 2 * r >= abs(int(b)):
            q += 1
        out.append(-q if (a < 0) != (b < 0) else q)
    return out


def np_lt(ah, al, bh, bl):
    return (ah < bh) | (
        (ah == bh) & (al.astype(np.uint64) < bl.astype(np.uint64))
    )


def np_eq(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def np_to_double(hi, lo):
    return hi.astype(np.float64) * 2.0**64 + lo.astype(np.uint64).astype(
        np.float64
    )


# ---------------------------------------------------------------------------
# device function registration


def register_i128_functions() -> None:
    """Register the ``__i128_*`` device functions (idempotent)."""
    import jax.numpy as jnp

    from ..dtypes import BIGINT, BOOLEAN, DOUBLE
    from ..expr.registry import DEFAULT_REGISTRY as reg, INTEGER, NUMERIC

    if reg.signatures("__i128_add_lo"):
        return

    def _u(x):
        return x.astype(jnp.uint64)

    def f(name, arity, out, fn):
        reg.register(
            name, [NUMERIC] * arity, out,
            (lambda g: lambda ctx, out_t, arg_ts, *a: g(
                *[x.astype(jnp.int64) for x in a]
            ))(fn),
        )

    f("__i128_add_lo", 2, BIGINT, lambda al, bl: al + bl)
    f(
        "__i128_add_hi", 4, BIGINT,
        lambda ah, al, bh, bl: ah + bh + (_u(al + bl) < _u(al)).astype(jnp.int64),
    )
    f("__i128_neg_lo", 1, BIGINT, lambda lo: -lo)
    f(
        "__i128_neg_hi", 2, BIGINT,
        lambda hi, lo: ~hi + (lo == 0).astype(jnp.int64),
    )
    f(
        "__i128_lt", 4, BOOLEAN,
        lambda ah, al, bh, bl: (ah < bh) | ((ah == bh) & (_u(al) < _u(bl))),
    )
    f(
        "__i128_lte", 4, BOOLEAN,
        lambda ah, al, bh, bl: (ah < bh) | ((ah == bh) & (_u(al) <= _u(bl))),
    )
    f("__i128_eq", 4, BOOLEAN, lambda ah, al, bh, bl: (ah == bh) & (al == bl))
    f(
        "__i128_to_double", 2, DOUBLE,
        lambda hi, lo: hi.astype(jnp.float64) * 2.0**64
        + _u(lo).astype(jnp.float64),
    )

    def _mul_parts(a, b):
        au, bu = _u(a), _u(b)
        m32 = jnp.uint64(_MASK32)
        s32 = jnp.uint64(32)
        a0, a1 = au & m32, au >> s32
        b0, b1 = bu & m32, bu >> s32
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        mid = (p00 >> s32) + (p01 & m32) + (p10 & m32)
        lo = ((mid & m32) << s32) | (p00 & m32)
        hi_u = p11 + (p01 >> s32) + (p10 >> s32) + (mid >> s32)
        hi = hi_u.astype(jnp.int64)
        hi = hi - jnp.where(a < 0, b, 0) - jnp.where(b < 0, a, 0)
        return hi, lo.astype(jnp.int64)

    f("__i128_mul64_hi", 2, BIGINT, lambda a, b: _mul_parts(a, b)[0])
    f("__i128_mul64_lo", 2, BIGINT, lambda a, b: _mul_parts(a, b)[1])
    # 32-bit pieces + shifts for overflow-free sum accumulation and limb
    # recombination (exec/hugeint.py): a limb splits into an unsigned low
    # half (p0), an unsigned (p1u) or sign-carrying (sar32) high half
    f(
        "__i128_p0", 1, BIGINT,
        lambda x: (_u(x) & jnp.uint64(_MASK32)).astype(jnp.int64),
    )
    f(
        "__i128_p1u", 1, BIGINT,
        lambda x: (_u(x) >> jnp.uint64(32)).astype(jnp.int64),
    )
    f("__i128_sar32", 1, BIGINT, lambda x: x >> 32)
    f("__i128_sar63", 1, BIGINT, lambda x: x >> 63)
    f("__i128_shl32", 1, BIGINT, lambda x: x << 32)
    f("__i128_cast_double", 1, DOUBLE, lambda x: x.astype(jnp.float64))

    # --- full 128x128 truncated multiply ---------------------------------
    # (ah*2^64+al)*(bh*2^64+bl) mod 2^128: lo = wrap(al*bl) (=mul64_lo);
    # hi = mulhi_u(al,bl) + wrap(al*bh) + wrap(ah*bl).  Wrapping products
    # are sign-agnostic; only the 64x64 high word needs unsigned care.
    def _mulhi_u(a, b):
        au, bu = _u(a), _u(b)
        m32 = jnp.uint64(_MASK32)
        s32 = jnp.uint64(32)
        a0, a1 = au & m32, au >> s32
        b0, b1 = bu & m32, bu >> s32
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        mid = (p00 >> s32) + (p01 & m32) + (p10 & m32)
        return (a1 * b1 + (p01 >> s32) + (p10 >> s32) + (mid >> s32)).astype(
            jnp.int64
        )

    f(
        "__i128_mul_hi", 4, BIGINT,
        lambda ah, al, bh, bl: _mulhi_u(al, bl) + al * bh + ah * bl,
    )

    # checked 128x128 multiply: same hi limb plus a per-row overflow lane
    # (reference: DecimalUtil.h multiply uses __builtin_mul_overflow on
    # __int128 and throws).  Overflow is detected on magnitudes: the 256-bit
    # unsigned product |a|*|b| must fit in 127 bits (128 for the -2^127 edge).
    def _umul128(au, bu):
        """uint64 x uint64 -> (hi, lo) uint64 words of the exact product."""
        m32 = jnp.uint64(_MASK32)
        s32 = jnp.uint64(32)
        a0, a1 = au & m32, au >> s32
        b0, b1 = bu & m32, bu >> s32
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        mid = (p00 >> s32) + (p01 & m32) + (p10 & m32)
        lo = ((mid & m32) << s32) | (p00 & m32)
        hi = a1 * b1 + (p01 >> s32) + (p10 >> s32) + (mid >> s32)
        return hi, lo

    def _mag_u(hi, lo):
        neg = hi < 0
        nlo = -lo
        nhi = ~hi + (lo == 0).astype(jnp.int64)
        return (
            jnp.where(neg, nhi, hi).astype(jnp.uint64),
            jnp.where(neg, nlo, lo).astype(jnp.uint64),
            neg,
        )

    def _mul_chk_hi(ah, al, bh, bl):
        mah, mal, na = _mag_u(ah, al)
        mbh, mbl, nb = _mag_u(bh, bl)
        p_hi, p_lo = _umul128(mal, mbl)  # Al*Bl
        c1_hi, c1_lo = _umul128(mah, mbl)  # Ah*Bl
        c2_hi, c2_lo = _umul128(mal, mbh)  # Al*Bh
        cross = c1_lo + c2_lo
        hi = p_hi + cross
        zero = jnp.uint64(0)
        over = (
            ((mah != zero) & (mbh != zero))
            | (c1_hi != zero)
            | (c2_hi != zero)
            | (cross < c1_lo)
            | (hi < p_hi)
        )
        neg = na ^ nb
        top_set = (hi >> jnp.uint64(63)) != zero
        edge = neg & (hi == (jnp.uint64(1) << jnp.uint64(63))) & (p_lo == zero)
        over = over | (top_set & ~edge)
        sh = hi.astype(jnp.int64)
        sl = p_lo.astype(jnp.int64)
        nsh = ~sh + (sl == 0).astype(jnp.int64)
        return jnp.where(neg, nsh, sh), over

    f("__i128_mul_chk_hi", 4, BIGINT, _mul_chk_hi)

    # identity on the lo limb whose second arg exists only to pull the hi
    # limb's error lane into this expression (TRY-over-long-decimal lowering)
    reg.register(
        "__i128_pair_lo", [NUMERIC, NUMERIC], BIGINT,
        lambda ctx, out_t, arg_ts, lo, hi: lo,
    )

    # double -> i128 limbs with round-half-away (reference:
    # DecimalUtil::rescaleDouble — the scale factor is multiplied in by the
    # lowering as a DOUBLE expression before this conversion)
    def _from_double(x, which):
        # Exact conversion: a float64's integer value is mantissa * 2^e with a
        # 53-bit mantissa, so decompose with frexp and shift the mantissa into
        # the limbs with INTEGER ops.  Computing lo as a float64 difference
        # (the first implementation) rounds to the float spacing near 2^64
        # (2048), silently corrupting the low 11 bits of every converted
        # value — e.g. cast(-2.25 as decimal(30,10)) came back -2.2499999744.
        r = jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)
        err = ~jnp.isfinite(x) | (jnp.abs(r) >= 2.0**127)
        rs = jnp.where(err, 0.0, r)
        m2, e2 = jnp.frexp(jnp.abs(rs))  # |rs| = m2 * 2^e2, m2 in [0.5, 1)
        m = (m2 * 2.0**53).astype(jnp.uint64)  # exact: integer in [2^52, 2^53)
        sh = e2.astype(jnp.int64) - 53  # value = m << sh (sh in [-53, 74])
        shn = _u(jnp.maximum(-sh, 0))  # |rs| integer => low shn bits of m are 0
        shp = _u(jnp.minimum(jnp.maximum(sh, 0), 127))
        u64, u63, u0 = jnp.uint64(64), jnp.uint64(63), jnp.uint64(0)
        m = m >> shn
        lo = jnp.where(shp < u64, m << shp, u0)
        hi = jnp.where(
            shp == u0,
            u0,
            jnp.where(
                shp < u64,
                m >> (u64 - jnp.minimum(shp, u63)),
                m << (shp - u64),
            ),
        )
        neg = rs < 0.0
        nlo = -lo
        nhi = ~hi + (lo == jnp.uint64(0)).astype(jnp.uint64)
        lo = jnp.where(neg, nlo, lo)
        hi = jnp.where(neg, nhi, hi)
        if which == "hi":
            return hi.astype(jnp.int64), err
        return lo.astype(jnp.int64)

    reg.register(
        "__i128_from_double_hi", [NUMERIC], BIGINT,
        lambda ctx, out_t, arg_ts, x: _from_double(
            x.astype(jnp.float64), "hi"
        ),
    )
    reg.register(
        "__i128_from_double_lo", [NUMERIC], BIGINT,
        lambda ctx, out_t, arg_ts, x: _from_double(
            x.astype(jnp.float64), "lo"
        ),
    )

    # --- rounded signed division -----------------------------------------
    # Shift-subtract 128/128 long division on magnitudes (128 fori_loop
    # iterations of fused u64 ops — branch-free, data-parallel), then
    # round half away from zero.  Reference: DecimalUtil::divideWithRoundUp.
    from jax import lax

    def _mag(hi, lo):
        neg = hi < 0
        nlo = -lo
        nhi = ~hi + (lo == 0).astype(jnp.int64)
        return (
            _u(jnp.where(neg, nhi, hi)),
            _u(jnp.where(neg, nlo, lo)),
            neg,
        )

    def _div_signed(ah, al, bh, bl):
        """(q_hi, q_lo, err) — round-half-away quotient; err on b == 0."""
        err = (bh == 0) & (bl == 0)
        bl_s = jnp.where(err, jnp.ones_like(bl), bl)
        bh_s = jnp.where(err, jnp.zeros_like(bh), bh)
        nh, nl, na = _mag(ah, al)
        dh, dl, nb = _mag(bh_s, bl_s)
        one = jnp.uint64(1)
        s63 = jnp.uint64(63)
        zero = jnp.zeros_like(nh)

        def body(_, st):
            qh, ql, rh, rl, xh, xl = st
            rh = (rh << one) | (rl >> s63)
            rl = (rl << one) | (xh >> s63)
            xh = (xh << one) | (xl >> s63)
            xl = xl << one
            ge = (rh > dh) | ((rh == dh) & (rl >= dl))
            borrow = (rl < dl).astype(jnp.uint64)
            rh2, rl2 = rh - dh - borrow, rl - dl
            rh = jnp.where(ge, rh2, rh)
            rl = jnp.where(ge, rl2, rl)
            qh = (qh << one) | (ql >> s63)
            ql = (ql << one) | ge.astype(jnp.uint64)
            return (qh, ql, rh, rl, xh, xl)

        qh, ql, rh, rl, _, _ = lax.fori_loop(
            0, 128, body, (zero, zero, zero, zero, nh, nl)
        )
        # round half away: 2*r >= d  (r < d < 2^127, so 2r fits u128)
        r2h = (rh << one) | (rl >> s63)
        r2l = rl << one
        bump = ((r2h > dh) | ((r2h == dh) & (r2l >= dl))).astype(jnp.uint64)
        ql2 = ql + bump
        qh = qh + (ql2 < ql).astype(jnp.uint64)
        ql = ql2
        # apply sign
        neg = na ^ nb
        sh, sl = qh.astype(jnp.int64), ql.astype(jnp.int64)
        nql = -sl
        nqh = ~sh + (sl == 0).astype(jnp.int64)
        return (
            jnp.where(neg, nqh, sh),
            jnp.where(neg, nql, sl),
            err,
        )

    def _div_lo(*a):
        r = _div_signed(*a)
        return r[1], r[2]

    f("__i128_div_hi", 4, BIGINT, lambda *a: _div_signed(*a)[0])
    f("__i128_div_lo", 4, BIGINT, _div_lo)

    # --- guards ------------------------------------------------------------
    # passthrough-with-error-lane helper: the lowering attaches this to one
    # limb expression so overflow surfaces as a per-row query error (the
    # reference throws VeloxUserError on decimal overflow)
    def _guard_abs_le(x, ah, al, th, tl):
        neg = ah < 0
        mh = _u(jnp.where(neg, ~ah + (al == 0).astype(jnp.int64), ah))
        ml = _u(jnp.where(neg, -al, al))
        over = (mh > _u(th)) | ((mh == _u(th)) & (ml > _u(tl)))
        return x, over

    f("__i128_guard_abs_le", 5, BIGINT, _guard_abs_le)

    # narrow a 128-bit value into int64 (err when it does not fit)
    f(
        "__i128_narrow", 2, BIGINT,
        lambda hi, lo: (lo, hi != (lo >> 63)),
    )
