"""Double-float (2 x f32) arithmetic for f64-accuracy residuals (port of
orc_tpu/ops/df32.py).

A value carries f64-like precision as an (hi, lo) pair of float32
tensors. Products of the hi parts are exact two-products plus first-
order cross terms (hi*lo), so a product keeps ~2^-45 relative accuracy;
sums are error-free two-sums, so long reductions keep their low bits.

Every function is plain torch on tensors, in orc_tpu's order of
operations. Torch runs each operation eagerly as its own kernel, so no
compiler can contract a multiply and an add into an FMA or reassociate
a two-sum: the error-free transforms hold on the CPU and on the card
alike (tests/test_torch_df32.py measures the 39-step chain orc_tpu
measured on its TPU). Nothing here may go through `torch.compile`,
whose code generator may contract FMAs.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0  # 2^12 + 1 (Dekker split constant for f32)


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi carrying the top 12 bits."""
    c = a * _SPLIT
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker, 17 flops)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_from_f64(x):
    """(hi, lo) float32 pair of a float64 tensor (lossless to ~2^-48)."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def df_to_f64(hi, lo):
    return hi.to(torch.float64) + lo.to(torch.float64)


def df_add(xh, xl, yh, yl):
    """Double-float addition (AccurateDWPlusDW-style, branch-free)."""
    sh, se = two_sum(xh, yh)
    tl, te = two_sum(xl, yl)
    c = se + tl
    vh, vl = fast_two_sum(sh, c)
    return fast_two_sum(vh, vl + te)


def df_mul(xh, xl, yh, yl):
    """Double-float multiply: exact hi*hi two-product plus first-order
    cross terms."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_spmv(diag_h, diag_l, off_h, off_l, offsets, xh, xl):
    """Structured (shift) ELL SpMV in double-float: y = D x +
    sum_k off_k * roll(x, -d_k). Returns (yh, yl). off planes are
    [..., C, K]; the wrap-around of the roll meets zero coefficients
    (the EllMatrix offsets contract)."""
    yh, yl = df_mul(diag_h, diag_l, xh, xl)
    for k, d in enumerate(offsets):
        d = int(d)
        xkh = torch.roll(xh, -d, dims=-1) if d != 0 else xh
        xkl = torch.roll(xl, -d, dims=-1) if d != 0 else xl
        ph, pl_ = df_mul(off_h[..., k], off_l[..., k], xkh, xkl)
        yh, yl = df_add(yh, yl, ph, pl_)
    return yh, yl


def df_sum(p, e=None):
    """Error-tracked binary-tree sum over the last axis of a float32
    tensor: (hi, lo), with every level's two_sum errors collected and the
    error plane reduced in plain f32 (second order, ~2^-48 relative).
    `e` optionally seeds the error plane (the product low parts in
    df_dot)."""
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    err = zero if e is None else torch.sum(e)
    n = p.shape[-1]
    while n > 1:
        half = n // 2
        a, b = p[..., :half], p[..., half : 2 * half]
        s, t = two_sum(a, b)
        err = err + torch.sum(t)
        if n % 2:
            s = torch.cat([s, p[..., -1:]], dim=-1)
            half += 1
        p = s
        n = half
    return fast_two_sum(p[..., 0], err)


def df_dot(xh, xl, yh, yl):
    """Double-float dot product: error-free per-element products plus
    an error-tracked tree reduction. Returns (hi, lo)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return df_sum(ph, pe)
